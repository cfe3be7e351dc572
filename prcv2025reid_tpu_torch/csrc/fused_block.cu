// The two bf16 block kernels of the folded (eval/serving) transformer block,
// on the persistent wgmma + TMA core of hopper_gemm.cuh.
//
// Replaces: prcv2025reid_tpu/ops/fused_block.py::_ln_qkv_kernel_bf16
// (fused_ln_qkv, quant="bf16") and ::_out_mlp_kernel_bf16 (fused_out_mlp,
// quant="bf16").
//
// Bound on an H100 (ViT-B/16, G=1, T=25,216 rows; 989 TFLOP/s dense bf16,
// 3.35 TB/s): LN1+QKV is 89.2 GFLOP (0.090 ms) against 158 MB;
// out-proj+LN2+MLP 267.7 GFLOP (0.271 ms) against 116 MB: both are bound by
// operations.  The TPU kernels keep every weight and a whole row tile resident
// in ~15 MB of VMEM; a Hopper block has 227 KB of shared memory, so the
// weights stream through it and the work is split where a whole row is needed.
// A LayerNorm cannot sit between a TMA load and a wgmma that reads shared
// memory, so each LN is a row pass (one warp per row, the row held in
// registers, the two-pass f32 statistics) that writes y = bf16(LN(.)), which
// is exactly what the TPU kernels feed their products (y.astype(dt)); y goes
// through device memory once, written once and read once:
//   fused_ln_qkv   = two launches:
//                    1. LN1 row pass on the bf16 x: y [T, D] bf16 (38.7 MB);
//                    2. QKV: y @ Wqkv, epilogue out = bf16(acc + b); 128 x 192
//                       tiles (12 column tiles at O = 2304; 128 x 256, whose
//                       last wave is 43% full, measured 2% slower).
//   fused_out_mlp  = four launches:
//                    1. out_proj: attn @ Wo, epilogue x2 = x + (acc + bo) in
//                       f32 (the TPU kernel never rounds x2 to bf16), stored
//                       by TMA in [64][64] sub-tiles; 128 x 192 tiles (788
//                       tiles at G=1: 6 even waves on 132 SMs);
//                    2. LN2 row pass on the f32 x2: y = bf16(LN(x2));
//                    3. fc1 = the fused MLP's fc1 (fused_mlp.cu): y @ W1,
//                       epilogue h = bf16(GELU_erf(acc + b1)) with the
//                       Abramowitz-Stegun erf the TPU kernel uses; 128 x 256;
//                    4. fc2: h @ W2, epilogue out = bf16(x2 + (acc + b2));
//                       128 x 192.
//                  h ([T, F] bf16, 155 MB) goes through device memory once.
//                  Step 1 alone is also exported as out_proj: the bf16
//                  out-projection of the mixed int8 plan
//                  (fused_block_int8.cu).
#include "hopper_gemm.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_K = 32 * 8 * 4;  // a row pass holds a row of <= 1024 in registers

// One warp's row (K <= MAX_K, K % 8 == 0) into registers, zero past K, and
// its f32 LayerNorm statistics: the mean, then the mean squared deviation
// (two passes over the registers); returns (mean, 1/sqrt(var + eps)).
template <typename AT>
__device__ __forceinline__ float2 load_row_stats(const AT* xr, int K, float eps, int lane,
                                                 float (&v)[4][8]) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < K) {
      load8<AT>(xr + col, v[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[c][e];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / K;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if ((c * 32 + lane) * 8 < K) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sq += (v[c][e] - mu) * (v[c][e] - mu);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  return make_float2(mu, rsqrtf(sq / K + eps));
}

// LN of bf16 (x, LN1) or f32 (x2, LN2) rows into a GEMM's bf16 operand, one
// warp per row: y = bf16(((x - mu) * rstd) * s + b)
template <typename AT>
__global__ void __launch_bounds__(256) ln_rows_kernel(const AT* __restrict__ x,
                                                      const float* __restrict__ ln_s,
                                                      const float* __restrict__ ln_b,
                                                      bf16* __restrict__ y, int rows, int K,
                                                      float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float v[4][8];
  const float2 st = load_row_stats<AT>(x + static_cast<long long>(row) * K, K, eps, lane, v);
  bf16* yr = y + static_cast<long long>(row) * K;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < K) {
      float s[8], b[8];
      load8<float>(ln_s + col, s);
      load8<float>(ln_b + col, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[c][e] = ((v[c][e] - st.x) * st.y) * s[e] + b[e];
      *reinterpret_cast<uint4*>(yr + col) =
          make_uint4(pack_bf16(v[c][0], v[c][1]), pack_bf16(v[c][2], v[c][3]),
                     pack_bf16(v[c][4], v[c][5]), pack_bf16(v[c][6], v[c][7]));
    }
  }
}

bool row_pass_takes(int K) { return K > 0 && K <= MAX_K && K % 8 == 0; }

template <typename AT>
cudaError_t run_ln_rows(const void* x, const void* ln_s, const void* ln_b, void* y, int rows,
                        int K, float eps, cudaStream_t stream) {
  ln_rows_kernel<AT><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const AT*>(x), static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
      static_cast<bf16*>(y), rows, K, eps);
  return cudaGetLastError();
}

}  // namespace

// qkv[g] = bf16(bf16(LN(x[g])) @ w[g] + b[g]);  x [G,T,D] bf16, w [G,D,O]
// bf16, ln_s/ln_b [D] f32, b [G,O] f32, out [G,T,O] bf16; y [G,T,D] bf16 is
// caller-allocated scratch.  D % 8 == 0, D <= 1024, O % 8 == 0 (16-byte TMA
// strides).  Two launches: the LN1 row pass into y, then the GEMM.
extern "C" int ln_qkv(const void* x, const void* ln_s, const void* ln_b,
                      const void* w, const void* b, void* y, void* out, int G,
                      int T, int D, int O, float eps, void* stream) {
  if (G <= 0 || T <= 0 || !row_pass_takes(D) || O <= 0 || O % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = run_ln_rows<bf16>(x, ln_s, ln_b, y, G * T, D, eps, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const hgemm::Params p{T, O, D, G, static_cast<const float*>(b)};
  return static_cast<int>(
      hgemm::gemm<hgemm::Bf16Op, hgemm::Bf16Out<hgemm::BIAS>, 128, 192, 2, 4>(y, w, out, p, st));
}

// x2[g] = x[g] + (attn[g] @ wo[g] + bo[g]) in f32: the out-projection alone,
// also the first step of the mixed int8 plan (csrc/fused_block_int8.cu runs
// the rest).  attn, x [G,T,D] bf16; wo [G,D,D] bf16; bo [G,D] f32; x2
// [G,T,D] f32.  D % 8 == 0.  One launch.
extern "C" int out_proj(const void* attn, const void* x, const void* wo, const void* bo,
                        void* x2, int G, int T, int D, void* stream) {
  if (G <= 0 || T <= 0 || D <= 0 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  hgemm::Params p{T, D, D, G, static_cast<const float*>(bo), x};
  return static_cast<int>(hgemm::gemm<hgemm::Bf16Op, hgemm::F32Out<hgemm::RES_X>, 128, 192, 2, 4>(
      attn, wo, x2, p, static_cast<cudaStream_t>(stream)));
}

// out[g] = bf16(x2 + GELU(LN(x2) @ w1[g] + b1[g]) @ w2[g] + b2[g]) with
// x2 = x[g] + attn[g] @ wo[g] + bo[g] in f32.  attn, x [G,T,D] bf16; wo
// [G,D,D], w1 [G,D,F], w2 [G,F,D] bf16; bo, b1, b2 [G,*] f32; ln [D] f32.
// x2 [G,T,D] f32, y [G,T,D] bf16 and h [G,T,F] bf16 are caller-allocated
// scratch.  D % 8 == 0, D <= 1024, F % 8 == 0.  Four launches: out-proj,
// LN2, fc1, fc2.
extern "C" int out_mlp(const void* attn, const void* x, const void* wo,
                       const void* bo, const void* ln_s, const void* ln_b,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, void* x2, void* y, void* h, void* out,
                       int G, int T, int D, int F, float eps, void* stream) {
  if (!row_pass_takes(D) || F <= 0 || F % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = out_proj(attn, x, wo, bo, x2, G, T, D, stream);
  if (e != 0) return e;
  if ((e = run_ln_rows<float>(x2, ln_s, ln_b, y, G * T, D, eps, st)) != cudaSuccess) return e;
  const hgemm::Params fc1{T, F, D, G, static_cast<const float*>(b1)};
  e = hgemm::gemm<hgemm::Bf16Op, hgemm::Bf16Out<hgemm::BIAS_GELU>, 128, 256, 2, 3>(y, w1, h, fc1,
                                                                                    st);
  if (e != 0) return e;
  const hgemm::Params fc2{T, D, F, G, static_cast<const float*>(b2), x2};
  return static_cast<int>(
      hgemm::gemm<hgemm::Bf16Op, hgemm::Bf16Out<hgemm::RES_X2>, 128, 192, 2, 4>(h, w2, out, fc2, st));
}
