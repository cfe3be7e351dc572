// Helpers shared by the port's Hopper kernels: mma.sync m16n8k16 (bf16
// inputs, f32 accumulators) and ldmatrix for the attention kernel, bf16
// packing and 8-value row loads, the GELU.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A 16x16 (row-major): a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                        a2 = (g, 2t+8..+9)   a3 = (g+8, 2t+8..+9)
//   B 16x8  (k x n):     b0 = (k 2t..2t+1, n g)   b1 = (k 2t+8..+9, n g)
//   C 16x8  (f32):       c0,c1 = (g, 2t..2t+1)    c2,c3 = (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace port {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l supplies the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b  (m16n8k16, bf16 x bf16 -> f32)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// eight consecutive values (16-byte aligned) of a row as f32
template <typename AT>
__device__ __forceinline__ void load8(const AT* p, float (&v)[8]);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&v)[8]) {
  const float4 x0 = *reinterpret_cast<const float4*>(p);
  const float4 x1 = *reinterpret_cast<const float4*>(p + 4);
  v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
  v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
}

// ---- row passes (LayerNorm, quantization, residual + LN): a row of K
// values (K % 8 == 0) in registers, as CH chunks of 8 a thread; chunk c of
// thread l lies at column (c L + l) 8.  Up to ROW_WARP_MAX columns one warp
// holds a row (L = 32; CH = 4 to 1,024, the instantiation every width up to
// it has always run, CH = 8 past it); past that one block does (L =
// blockDim.x, a multiple of 32 of up to 1,024 threads, CH = 4) and its
// statistics combine the warps' partials through shared memory, so a row
// runs to ROW_MAX columns.
constexpr int ROW_WARP_MAX = 2048;
constexpr int ROW_BLOCK_CH = 4;
constexpr int ROW_MAX = 1024 * 8 * ROW_BLOCK_CH;  // 32,768

inline bool row_pass_takes(int K) { return K > 0 && K % 8 == 0 && K <= ROW_MAX; }

// the threads of a block-per-row pass over K columns
inline int row_block_threads(int K) {
  return (K / 8 + 32 * ROW_BLOCK_CH - 1) / (32 * ROW_BLOCK_CH) * 32;
}

// the row's sum of x over the threads that hold it: the warp's shuffles and,
// for a block's row, the warps' partials added in warp order through red[32]
template <bool BLOCK>
__device__ __forceinline__ float row_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  if constexpr (BLOCK) {
    __syncthreads();  // red's earlier readers are done
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
    __syncthreads();
    x = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) x += red[w];
  }
  return x;
}

// the same for the row's maximum of non-negative values (max |y|)
template <bool BLOCK>
__device__ __forceinline__ float row_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if constexpr (BLOCK) {
    __syncthreads();
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
    __syncthreads();
    x = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) x = fmaxf(x, red[w]);
  }
  return x;
}

// this thread's place in its row: (row, l, L) of a warp's row (eight rows a
// 256-thread block) or of a block's
template <bool BLOCK>
__device__ __forceinline__ int3 row_place() {
  if constexpr (BLOCK) return make_int3(blockIdx.x, threadIdx.x, blockDim.x);
  return make_int3(blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, threadIdx.x % 32, 32);
}

// 0.5 x (1 + erf(x / sqrt 2)) with the Abramowitz-Stegun 7.1.26 erf
// (|err| <= 1.5e-7) that the TPU kernels use (kernel_math.gelu_exact), its
// reciprocal and exponential from the hardware's approximate units: a few f32
// ulps, far below the bf16 rounding that follows, in a handful of
// instructions where the IEEE division and expf take tens
__device__ __forceinline__ float gelu_as(float x) {
  const float u = x * 0.7071067811865476f;
  const float a = fabsf(u);
  const float tt = __fdividef(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      tt * (0.254829592f +
            tt * (-0.284496736f + tt * (1.421413741f + tt * (-1.453152027f + tt * 1.061405429f))));
  const float erf_a = 1.0f - poly * __expf(-a * a);
  return 0.5f * x * (1.0f + copysignf(erf_a, u));
}

}  // namespace port
