// The three int8 block kernels of the folded (eval/serving) transformer block:
// row passes and int8 GEMMs (s8 x s8 -> exact s32 accumulators) with fused
// epilogues, every GEMM on the persistent s8 wgmma + TMA core of
// hopper_gemm.cuh.
//
// Replaces: prcv2025reid_tpu/ops/fused_block.py::_ln_qkv_kernel_int8
// (fused_ln_qkv, quant="int8"), ::_out_mlp_kernel_int8 (fused_out_mlp,
// quant="int8") and ::_out_mlp_kernel_int8mlp (quant="int8_mlp", whose bf16
// out-projection runs on the bf16 core through fused_block.cu::out_proj).
//
// Bound on an H100 (ViT-B/16, G=1, T=25,216 rows; 1,979 TOP/s dense int8,
// 989 TFLOP/s bf16, 3.35 TB/s): LN1+QKV is 89.2 G int8 operations (0.045 ms)
// against 157 MB of bf16 activations in and out (0.047 ms): bytes.
// Out-proj+LN2+MLP is 267.7 G operations: 0.135 ms all int8, 0.150 ms with the
// bf16 out-projection, against 116 MB: operations.  The TPU kernels keep a
// 256-row tile and every weight in VMEM and quantize each activation row in
// registers right where it is produced; a Hopper block has 227 KB of shared
// memory, so the work is split at each point where a whole row is needed:
//   ln_qkv_int8   = row pass (LN1 in f32, one warp per row held in registers,
//                   then the row's max |y| and y / s rounded half to even ->
//                   int8 [T, D] and s [T]), then the QKV GEMM (128 x 192
//                   tiles, 2% faster than 128 x 256), epilogue
//                   bf16((dq(acc) = (acc * s_row) * ws_col) + b).
//   mlp_int8      = the int8 MLP tail on x2 [T, D] f32, four launches and a
//                   memset: row pass LN2 + quantize; fc1 (128 x 256 tiles),
//                   epilogue h = GELU(dq(acc) + b1) in f32 stored by TMA in
//                   [64][64] sub-tiles, with each row's max |h| (atomicMax on
//                   the bits of the non-negative float); a pass quantizing h
//                   (from f32, not bf16, as the TPU kernel does); fc2 (128 x
//                   192 tiles: 6 even waves on 132 SMs at D = 768), epilogue
//                   bf16((x2 + dq(acc)) + b2).  h goes through device memory
//                   as f32 (2 x 310 MB at the slice's shape): the row max has
//                   to be complete before any of h is quantized.
//   out_mlp_int8  = a row pass quantizing the attention rows, the
//                   out-projection (128 x 192 tiles), epilogue x2 = (x +
//                   dq(acc)) + bo in f32 stored in [64][64] sub-tiles, then
//                   mlp_int8.
//
// Rounding follows the TPU kernels exactly where it can: scales are
// max(max|y| / 127, 1e-8) and quantized values y / s, both IEEE divisions
// (__fdiv_rn), rounded half to even (__float2int_rn); the dequantization and
// the residual adds are separate f32 roundings in the TPU kernels' order
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs).  What can
// still differ: the LN statistics (summation order, rsqrtf) and the GELU's
// approximate reciprocal and exponential, by a few f32 ulps, which flips an
// int8 rounding only where a value lies within those ulps of a half step.
#include "hopper_gemm.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROW_MAX_K = 32 * 8 * 4;  // a row pass holds a row of <= 1024 in registers
// the out-projection's column tile: 4 of them at D = 768; on an H100 at T =
// 25,216 rows 128 x 192 (4 stages) took 82.7 us, 128 x 256 (3 stages, 3 tiles)
// 86.6 us (PERF.md)
constexpr int OUT_TN = 192, OUT_STAGES = 4;

// the per-row scale of the TPU kernels' _quant_rows: max(max|y| / 127, 1e-8)
__device__ __forceinline__ float row_scale(float maxabs) {
  return fmaxf(__fdiv_rn(maxabs, 127.0f), 1e-8f);
}

// four values -> round(v / s) half to even as int8, packed low byte first
__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float s) {
  const int qa = __float2int_rn(__fdiv_rn(a, s)), qb = __float2int_rn(__fdiv_rn(b, s));
  const int qc = __float2int_rn(__fdiv_rn(c, s)), qd = __float2int_rn(__fdiv_rn(d, s));
  return (static_cast<uint32_t>(qa) & 0xffu) | ((static_cast<uint32_t>(qb) & 0xffu) << 8) |
         ((static_cast<uint32_t>(qc) & 0xffu) << 16) | (static_cast<uint32_t>(qd) << 24);
}

// One warp per row: (LN in f32: the mean, then the mean squared deviation,
// ((v - mu) * rstd) * s + b, as the row passes of fused_block.cu compute
// it), then the row's int8 quantization.
template <typename AT, bool LN>
__global__ void __launch_bounds__(256) row_quant_kernel(
    const AT* __restrict__ x, const float* __restrict__ ln_s, const float* __restrict__ ln_b,
    int8_t* __restrict__ q, float* __restrict__ s, int rows, int K, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const AT* xr = x + static_cast<long long>(row) * K;
  float v[4][8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < K) {
      load8<AT>(xr + col, v[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[c][e] = 0.f;
    }
  }
  if (LN) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[c][e];
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
    const float rstd = rsqrtf(sq / K + eps);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = (c * 32 + lane) * 8;
      if (col < K) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[c][e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][e], mu), rstd), ln_s[col + e]),
                              ln_b[col + e]);
      }
    }
  }
  float m = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[c][e]));  // padding lanes hold 0
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = row_scale(m);
  int8_t* qr = q + static_cast<long long>(row) * K;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < K)
      *reinterpret_cast<uint2*>(qr + col) =
          make_uint2(quant4(v[c][0], v[c][1], v[c][2], v[c][3], sc),
                     quant4(v[c][4], v[c][5], v[c][6], v[c][7], sc));
  }
  if (lane == 0) s[row] = sc;
}

template <typename AT, bool LN>
cudaError_t run_row_quant(const void* x, const void* ln_s, const void* ln_b, void* q, void* s,
                          int rows, int K, float eps, cudaStream_t stream) {
  if (K > ROW_MAX_K || K % 16 != 0) return cudaErrorInvalidValue;
  row_quant_kernel<AT, LN><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const AT*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(q), static_cast<float*>(s), rows,
      K, eps);
  return cudaGetLastError();
}

// h [rows, F] f32 with its row maxima -> int8 [rows, F] and scales [rows];
// 16 values of one row per thread (F % 16 == 0)
__global__ void __launch_bounds__(256) quant_h_kernel(
    const float* __restrict__ h, const unsigned int* __restrict__ row_max,
    int8_t* __restrict__ q, float* __restrict__ s, long long n, int F) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 16;
  if (i >= n) return;
  const long long row = i / F;
  const float sc = row_scale(__uint_as_float(row_max[row]));
  const float4* src = reinterpret_cast<const float4*>(h + i);
  const float4 a = src[0], b = src[1], c = src[2], d = src[3];
  *reinterpret_cast<uint4*>(q + i) =
      make_uint4(quant4(a.x, a.y, a.z, a.w, sc), quant4(b.x, b.y, b.z, b.w, sc),
                 quant4(c.x, c.y, c.z, c.w, sc), quant4(d.x, d.y, d.z, d.w, sc));
  if (i % F == 0) s[row] = sc;
}

// LN2 + quantize, fc1 (GELU, row max), quantize h, fc2 + residual
cudaError_t mlp_tail(const void* x2, const void* ln_s, const void* ln_b, const void* w1q,
                     const void* w1s, const void* b1, const void* w2q, const void* w2s,
                     const void* b2, void* yq, void* ys, void* h, void* hmax, void* hq,
                     void* hs, void* out, int G, int T, int D, int F, float eps,
                     cudaStream_t st) {
  cudaError_t e;
  if (F <= 0 || F % 16 != 0) return cudaErrorInvalidValue;
  if ((e = run_row_quant<float, true>(x2, ln_s, ln_b, yq, ys, G * T, D, eps, st)) != cudaSuccess)
    return e;
  if ((e = cudaMemsetAsync(hmax, 0, sizeof(unsigned int) * G * static_cast<size_t>(T), st)) !=
      cudaSuccess)
    return e;
  const hgemm::Params fc1{T, F, D, G, static_cast<const float*>(b1), nullptr,
                          static_cast<const float*>(ys), static_cast<const float*>(w1s),
                          static_cast<unsigned int*>(hmax)};
  if ((e = hgemm::gemm<hgemm::S8Op, hgemm::F32Out<hgemm::DQ_GELU>, 128, 256, 2, 3>(
           yq, w1q, h, fc1, st)) != cudaSuccess)
    return e;
  const long long n = static_cast<long long>(G) * T * F;
  quant_h_kernel<<<static_cast<unsigned int>((n / 16 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(h), static_cast<const unsigned int*>(hmax),
      static_cast<int8_t*>(hq), static_cast<float*>(hs), n, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const hgemm::Params fc2{T, D, F, G, static_cast<const float*>(b2), x2,
                          static_cast<const float*>(hs), static_cast<const float*>(w2s)};
  return hgemm::gemm<hgemm::S8Op, hgemm::Bf16Out<hgemm::DQ_RES_X2>, 128, 192, 2, 4>(hq, w2q, out,
                                                                                    fc2, st);
}

}  // namespace

// qkv[g] = bf16(((quant(LN(x[g])) @ wq[g]) * s_row * ws[g]) + b[g]).  x [G,T,D]
// bf16; ln_s/ln_b [D] f32; wq [G,O,D] int8 (K-major); ws, b [G,O] f32; out
// [G,T,O] bf16; yq [G,T,D] int8 and ys [G*T] f32 are caller-allocated scratch.
// D % 16 == 0, D <= 1024, O % 8 == 0 (16-byte TMA strides).  Two launches:
// the LN1 + quantize row pass, then the s8 GEMM.
extern "C" int ln_qkv_int8(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                           const void* ws, const void* b, void* yq, void* ys, void* out, int G,
                           int T, int D, int O, float eps, void* stream) {
  if (G <= 0 || T <= 0 || D <= 0 || O <= 0 || O % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = run_row_quant<bf16, true>(x, ln_s, ln_b, yq, ys, G * T, D, eps, st)) != cudaSuccess)
    return e;
  const hgemm::Params p{T, O, D, G, static_cast<const float*>(b), nullptr,
                        static_cast<const float*>(ys), static_cast<const float*>(ws)};
  return static_cast<int>(
      hgemm::gemm<hgemm::S8Op, hgemm::Bf16Out<hgemm::DQ_BIAS>, 128, 192, 2, 4>(yq, wq, out, p, st));
}

// The LN2 + MLP half with fc1 and fc2 in int8, on x2 [G,T,D] f32 from the
// out-projection: out = bf16((x2 + o) + b2).  w1q [G,F,D], w2q [G,D,F] int8
// (K-major); w1s, b1 [G,F], w2s, b2 [G,D] f32.  Scratch: yq [G,T,D] int8, ys
// [G*T], h [G,T,F] f32, hmax [G*T] u32, hq [G,T,F] int8, hs [G*T].  Four
// launches and a memset.
extern "C" int mlp_int8(const void* x2, const void* ln_s, const void* ln_b, const void* w1q,
                        const void* w1s, const void* b1, const void* w2q, const void* w2s,
                        const void* b2, void* yq, void* ys, void* h, void* hmax, void* hq,
                        void* hs, void* out, int G, int T, int D, int F, float eps,
                        void* stream) {
  return static_cast<int>(mlp_tail(x2, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, yq, ys, h, hmax,
                                   hq, hs, out, G, T, D, F, eps,
                                   static_cast<cudaStream_t>(stream)));
}

// All three products in int8: aq/as = quant(attn); x2 = (x + (aq @ woq) *
// as * wos) + bo in f32; then mlp_int8 on x2.  attn, x [G,T,D] bf16; woq
// [G,D,D] int8 (K-major), wos, bo [G,D] f32; aq [G,T,D] int8, as [G*T] and
// x2 [G,T,D] f32 are scratch, the rest as for mlp_int8.  Six launches and a
// memset.
extern "C" int out_mlp_int8(const void* attn, const void* x, const void* woq, const void* wos,
                            const void* bo, void* aq, void* as, void* x2, const void* ln_s,
                            const void* ln_b, const void* w1q, const void* w1s, const void* b1,
                            const void* w2q, const void* w2s, const void* b2, void* yq,
                            void* ys, void* h, void* hmax, void* hq, void* hs, void* out,
                            int G, int T, int D, int F, float eps, void* stream) {
  if (G <= 0 || T <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = run_row_quant<bf16, false>(attn, nullptr, nullptr, aq, as, G * T, D, eps, st)) !=
      cudaSuccess)
    return e;
  const hgemm::Params proj{T, D, D, G, static_cast<const float*>(bo), x,
                           static_cast<const float*>(as), static_cast<const float*>(wos)};
  if ((e = hgemm::gemm<hgemm::S8Op, hgemm::F32Out<hgemm::DQ_RES_X>, 128, OUT_TN, 2, OUT_STAGES>(
           aq, woq, x2, proj, st)) != cudaSuccess)
    return e;
  return static_cast<int>(mlp_tail(x2, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, yq, ys, h, hmax,
                                   hq, hs, out, G, T, D, F, eps, st));
}
