// Fused residual add + LayerNorm of the fused-stream eval trunk.
//
// Replaces: prcv2025reid_tpu/ops/fused_resln.py::_resln_kernel
// (fused_residual_ln).
//
//   xn = bf16(x + branch)
//   y  = bf16(((xn - mu) * rsqrt(var + eps)) * scale + bias)
//
// with f32 statistics of the bf16-rounded xn: the mean first, then the mean
// squared deviation (two passes, as the TPU kernel computes them).
//
// Bound on an H100 (ViT-B/16 trunk, N = 128 * 197 = 25,216 rows of 768): the
// pass reads x and branch and writes xn and y, 4 * N * 768 * 2 B = 154.9 MB,
// ~46 us at 3.35 TB/s; at 8 FLOP per element it is bound by bytes.  The TPU
// kernel holds a 512-row tile in VMEM; here one warp owns a row (24 values
// per lane at D = 768) in registers, reads x and branch with 16-byte loads,
// reduces with warp shuffles and writes both outputs, so every byte moves
// once.  Eight rows per 256-thread block keep enough loads in flight.
#include "common.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int CHUNKS = 4;                // 8-value chunks per lane
constexpr int MAX_D = 32 * 8 * CHUNKS;   // 1024
constexpr int ROWS_PER_BLOCK = 8;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) resln_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ branch,
    const float* __restrict__ scale, const float* __restrict__ bias,
    bf16* __restrict__ xn, bf16* __restrict__ y, int rows, int D, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long base = static_cast<long long>(row) * D;
  float v[CHUNKS][8], sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < D) {
      float a[8], b[8];
      unpack8(*reinterpret_cast<const uint4*>(x + base + col), a);
      unpack8(*reinterpret_cast<const uint4*>(branch + base + col), b);
      uint4 packed;
      uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = pack_bf16(a[2 * e] + b[2 * e], a[2 * e + 1] + b[2 * e + 1]);
      *reinterpret_cast<uint4*>(xn + base + col) = packed;
      unpack8(packed, v[c]);  // the statistics see the rounded residual stream
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[c][e];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if ((c * 32 + lane) * 8 < D) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sq += (v[c][e] - mu) * (v[c][e] - mu);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float rstd = rsqrtf(sq / D + eps);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col >= D) continue;
    const float4 s0 = *reinterpret_cast<const float4*>(scale + col);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + col + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 packed;
    uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = pack_bf16(((v[c][2 * e] - mu) * rstd) * s[2 * e] + b[2 * e],
                       ((v[c][2 * e + 1] - mu) * rstd) * s[2 * e + 1] + b[2 * e + 1]);
    *reinterpret_cast<uint4*>(y + base + col) = packed;
  }
}

}  // namespace

// xn, y = fused_residual_ln(x, branch, scale, bias): x, branch, xn, y [N, D]
// bf16 (rows 16-byte aligned: D % 8 == 0, D <= 1024); scale, bias [D] f32.
// One launch.
extern "C" int resln(const void* x, const void* branch, const void* scale,
                     const void* bias, void* xn, void* y, int N, int D, float eps,
                     void* stream) {
  if (D % 8 != 0 || D > MAX_D || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  resln_kernel<<<(N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 32 * ROWS_PER_BLOCK, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(branch),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(xn), static_cast<bf16*>(y), N, D, eps);
  return static_cast<int>(cudaGetLastError());
}
