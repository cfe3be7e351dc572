// The tiled matmul of the roofline microbenchmark: out = x [M, K] @ w [K, N] on
// the tensor cores, in the two modes of the TPU probe:
//   bf16 x bf16 -> f32 accumulators -> bf16 out;
//   int8 x int8 -> exact s32 accumulators -> int32 out.
//
// Replaces: tools/perf_microbench.py::_pallas_matmul (pallas_call at :110),
// the plain tiled Pallas matmul behind the probes pallas_bf16, pallas_int8
// and pallas_sweep.
//
// Bound on an H100 at the probe's shape M = 25,344, K = 768, N = 3072 (119.6
// GFLOP; 989 TFLOP/s dense bf16, 1,979 TOP/s dense int8, 3.35 TB/s):
//   bf16: 0.1209 ms of operations against 199.4 MB (0.0595 ms): operations.
//   int8: 0.0604 ms of operations against 333.3 MB, 311 MB of it the int32
//         output (0.0995 ms): bytes.
// The TPU kernel keeps the whole [K, N] weight and one block_rows x K row
// tile in VMEM and makes one MXU product per grid step.  A Hopper block has
// 227 KB of shared memory, so the weight streams through it in k-tiles next
// to the row tile.
//
// Both modes are the persistent warp-specialised wgmma + TMA GEMM of
// hopper_gemm.cuh (the tensor cores reach their rate only through wgmma fed
// from shared memory):
//   - bf16 (operations-bound): stages of 64 k values; w row-major, read
//     MN-major through the transpose flag (no transposed copy of w); the
//     epilogue stages each consumer's tile as bf16 in swizzled shared memory
//     and stores it by TMA while the next tile's products run;
//   - int8 (bytes-bound by its int32 output): 8-bit wgmma (k32) takes both
//     operands K-major only, which the weight is ([K, N] view of [N, K]
//     storage), so a stage is one [rows][128 k] box of each operand; the
//     output, 64 KB of int32 a consumer and tile, leaves through two 16 KB
//     shared-memory buffers in [64][64] sub-tiles, each stored by TMA while
//     the next is written, the last two while the next tile's products run
//     (0.142 ms at block_rows 128 on an H100 80GB HBM3 at 700 W, 70% of the
//     byte bound; the mma.sync kernel it replaced took 0.295, PERF.md).
// block_rows (the TPU probe's row-block sweep) picks the tile: 64 -> 1
// consumer warpgroup of 64 x 256 (4-stage ring); 128 -> 2 of 64 x 256; 256
// -> 2 of 128 x 128 (two m64 products per k step; 3-stage rings).
// TMA zero-fills rows >= M and a k-tail past K on load and skips rows >= M
// and columns >= N on store, so a ragged M is computed in full (the TPU
// kernel's grid of m // block_rows steps leaves the last m % block_rows rows
// unwritten).  The wrapper takes K a multiple of 32 (bf16) or 64 (int8) and
// N of 128.
#include "hopper_gemm.cuh"

namespace {

using hgemm::Bf16Op;
using hgemm::Bf16Out;
using hgemm::S32Out;
using hgemm::S8Op;

template <class Op, class Out>
cudaError_t run(const void* x, const void* w, void* out, const hgemm::Params& p, int block_rows,
                cudaStream_t st) {
  switch (block_rows) {
    case 64: return hgemm::gemm<Op, Out, 64, 256, 1, 4>(x, w, out, p, st);
    case 128: return hgemm::gemm<Op, Out, 128, 256, 2, 3>(x, w, out, p, st);
    case 256: return hgemm::gemm<Op, Out, 256, 128, 2, 3>(x, w, out, p, st);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(bool int8, const void* x, const void* w, void* out, int M, int N, int K,
             int block_rows, void* stream) {
  if (M <= 0 || N <= 0 || N % 128 != 0 || K <= 0 || K % (int8 ? 64 : 32) != 0)
    return cudaErrorInvalidValue;
  const hgemm::Params p{M, N, K, 1, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(int8 ? run<S8Op, S32Out>(x, w, out, p, block_rows, st)
                               : run<Bf16Op, Bf16Out<hgemm::NONE>>(x, w, out, p, block_rows, st));
}

}  // namespace

// out [M, N] bf16 = x [M, K] bf16 @ w [K, N] bf16 (row-major), f32 accumulators.
extern "C" int matmul_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                           int block_rows, void* stream) {
  return dispatch(false, x, w, out, M, N, K, block_rows, stream);
}

// out [M, N] int32 = x [M, K] int8 @ w, with w [K, N] int8 stored K-major
// ([N, K] contiguous), exact s32 accumulators.
extern "C" int matmul_int8(const void* x, const void* w, void* out, int M, int N, int K,
                           int block_rows, void* stream) {
  return dispatch(true, x, w, out, M, N, K, block_rows, stream);
}
