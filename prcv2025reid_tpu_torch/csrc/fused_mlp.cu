// Fused transformer MLP of the eval path: fc1 -> exact GELU -> fc2, as two
// launches of the port's Hopper GEMM core (hopper_gemm.cuh) with fused
// epilogues.
//
// Replaces: prcv2025reid_tpu/ops/fused_mlp.py::_mlp_kernel (fused_mlp).
//
//   h[g]   = bf16(GELU(x[g] @ W1[g] + b1[g]))     fc1: K = D, N = F
//   out[g] = bf16(h[g] @ W2[g] + b2[g])           fc2: K = F, N = D
//
// with f32 accumulation, f32 bias adds and the Abramowitz-Stegun erf GELU of
// the TPU kernel (gelu_as), applied to the f32 accumulators in fc1's
// epilogue; the hidden activation is rounded to bf16 before fc2, as the TPU
// kernel rounds it.
//
// Bound on an H100 (ViT-B/16, N = 128 * 197 = 25,216 rows, D = 768,
// F = 3072): 4 * N * D * F = 2.38e11 FLOP, ~241 us at 989 TFLOP/s bf16,
// against 86.9 MB (~26 us), so it is bound by operations.  The TPU kernel
// keeps W1 and W2 (9.4 MB) resident in VMEM and streams row tiles.  On
// Hopper a fused kernel that keeps h on chip cannot also keep a 128 x 768
// f32 output accumulator there (384 KB against 256 KB of registers): it
// must shrink the row tile, which multiplies the weights' L2 traffic, or
// compute fc1 twice (this file's first design: 1.96 ms on an H100 80GB HBM3
// at 700 W, 8x its bound).  Here h goes through device memory once instead
// (written once and read once, 2 x 155 MB, mostly under the products), and
// each product runs on the persistent wgmma + TMA core (0.399 ms in all on
// the same card, PERF.md; fc1's GELU epilogue, not overlapped with the
// products, is most of what it loses to the bound):
//   - fc1: 128 x 256 tiles (two consumer warpgroups of 64 x 256, 3-stage
//     ring); the epilogue adds b1, applies the GELU in f32 and stages the
//     bf16 tile in swizzled shared memory for a TMA store;
//   - fc2: 128 x 192 tiles (4 column tiles of D = 768 and 197 row tiles fill
//     132 SMs in 6 even waves where 256-wide tiles would leave the fifth
//     wave half empty; 4-stage ring), b2 in the epilogue.
// Groups are the third dimension of every tensor map: a ragged group's tile
// is zero-filled past its last row on load and clipped on store, never
// touching the next group's rows.  The kernels allocate nothing: the wrapper
// passes h.
#include "hopper_gemm.cuh"

using hgemm::Bf16Op;
using hgemm::Bf16Out;

// out[g] = bf16(bf16(GELU(x[g] @ w1[g] + b1[g])) @ w2[g] + b2[g]):
// x, out [G,N,D] bf16; w1 [G,D,F], w2 [G,F,D] bf16; b1 [G,F], b2 [G,D] f32;
// h [G,N,F] bf16 scratch.  D % 8 == 0 and F % 8 == 0 (16-byte rows for TMA).
// Two launches on `stream`.
extern "C" int mlp(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* h, void* out, int G, int N, int D, int F,
                   void* stream) {
  if (D <= 0 || D % 8 != 0 || F <= 0 || F % 8 != 0 || N <= 0 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const hgemm::Params fc1{N, F, D, G, static_cast<const float*>(b1)};
  cudaError_t e =
      hgemm::gemm<Bf16Op, Bf16Out<hgemm::BIAS_GELU>, 128, 256, 2, 3>(x, w1, h, fc1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const hgemm::Params fc2{N, D, F, G, static_cast<const float*>(b2)};
  return static_cast<int>(hgemm::gemm<Bf16Op, Bf16Out<hgemm::BIAS>, 128, 192, 2, 4>(h, w2, out, fc2, st));
}
