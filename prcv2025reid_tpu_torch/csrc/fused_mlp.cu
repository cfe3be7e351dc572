// Fused transformer MLP of the eval path: fc1 -> exact GELU -> fc2 in one
// kernel, the [rows, F] hidden activation kept on chip.
//
// Replaces: prcv2025reid_tpu/ops/fused_mlp.py::_mlp_kernel (fused_mlp).
//
//   out[g] = bf16(bf16(GELU(x[g] @ W1[g] + b1[g])) @ W2[g] + b2[g])
//
// with f32 accumulation, f32 bias adds and the Abramowitz-Stegun erf GELU of
// the TPU kernel; the hidden activation is rounded to bf16 before fc2.
//
// Bound on an H100 (ViT-B/16, N = 128 * 197 = 25,216 rows, D = 768,
// F = 3072): 4 * N * D * F = 2.38e11 FLOP, ~241 us at 989 TFLOP/s bf16,
// against 86.9 MB (~26 us), so it is bound by operations.  The TPU kernel
// keeps W1 and W2 (9.4 MB) resident in VMEM and streams row tiles; 227 KB of
// shared memory cannot hold them, so here the weights stream from L2 in
// F-chunks while the row tile and its hidden chunk stay on chip:
//   - a block owns R = 64 rows and DN = 384 output columns (two blocks per
//     row tile at D = 768: each recomputes the hidden chunk, so fc1 runs
//     twice, 1.5x the minimum work, which keeps the f32 output accumulator
//     at 32 x 96 per warp, 96 registers);
//   - its x tile [64, D] is loaded once into shared memory;
//   - for each chunk of FC = 64 hidden units: h = x @ W1[:, chunk] with
//     128-deep W1 k-tiles in a 3-stage cp.async ring, then + b1, GELU in
//     f32, bf16 into shared memory, then out += h @ W2[chunk, cols] with the
//     W2 chunk copied in pieces alongside the first fc1 k-tiles of the chunk;
//   - fc1 gives each warp a 32 x 32 tile of h over half of every k-tile
//     (two k-groups of four warps, summed once per chunk through shared
//     memory, each group finishing half the rows): 8 independent
//     accumulators per step and half an ldmatrix per mma, where 16 x 32
//     tiles over whole k-tiles gave 4 and three quarters; its fragments are
//     double-buffered, so each ldmatrix lands a step before its mma;
//   - the GELU (gelu_as) uses the hardware's approximate reciprocal and
//     exponential: the epilogue runs between two barriers, so its latency
//     is paid in full;
//   - mma.sync m16n8k16 (bf16 in, f32 accumulators) with ldmatrix operand
//     loads from padded rows.
// Rows past N are zero-filled on load and never stored (no padding copies).
// On an H100 80GB HBM3 at 700 W this takes ~1.95 ms at the shape above
// (PERF.md): without any weight traffic it still takes 1.60 ms and without
// either product's mma 1.87, so what holds it is shared-memory operand
// traffic and the latency between barriers, not L2 or the tensor cores.
#include "common.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int R = 64;          // rows per block
constexpr int DN = 384;        // output columns per block
constexpr int FC = 64;         // hidden units per chunk
constexpr int BK = 128;        // fc1 k-tile depth
constexpr int STAGES = 3;      // fc1 W1 k-tile ring
constexpr int THREADS = 256;
constexpr int MAX_D = 768;     // the x tile, the ring and the buffers fill 227 KB
constexpr int LDW1 = FC + 8;   // 144 B rows: conflict-free ldmatrix
constexpr int LDH = FC + 8;
constexpr int LDW2 = DN + 8;   // 784 B rows
constexpr int LDRED = FC + 4;  // f32 partial sums of the second fc1 k-half
constexpr int W2_PIECES = FC * DN / 8;  // 16-byte pieces of one W2 chunk
constexpr int W1_BYTES = STAGES * BK * LDW1 * 2;
constexpr int W2_BYTES = FC * LDW2 * 2;
constexpr int H_BYTES = R * LDH * 2;
constexpr int RED_BYTES = R * LDRED * 4;
constexpr int W1_PER_THREAD = BK * FC / 8 / THREADS;  // 16-byte W1 pieces per k-tile
static_assert(BK * FC / 8 % THREADS == 0, "whole W1 pieces per thread");

int smem_bytes(int D) { return R * (D + 8) * 2 + W1_BYTES + W2_BYTES + H_BYTES + RED_BYTES; }

struct MlpArgs {
  const bf16* x;    // [G, N, D]
  const bf16* w1;   // [G, D, F]
  const float* b1;  // [G, F]
  const bf16* w2;   // [G, F, D]
  const float* b2;  // [G, D]
  bf16* out;        // [G, N, D]
  int N, D, F;
};

__global__ void __launch_bounds__(THREADS, 1) mlp_kernel(MlpArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, D = p.D, F = p.F;
  const int LDX = D + 8;  // (D + 8) / 8 is odd for D = 768: conflict-free ldmatrix
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW1 = sX + R * LDX;
  bf16* sW2 = sW1 + STAGES * BK * LDW1;
  bf16* sH = sW2 + FC * LDW2;
  float* sRed = reinterpret_cast<float*>(sH + R * LDH);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * DN, r0 = blockIdx.y * R, grp = blockIdx.z;
  const bf16* X = p.x + grp * static_cast<long long>(N) * D;
  const bf16* W1 = p.w1 + grp * static_cast<long long>(D) * F;
  const bf16* W2 = p.w2 + grp * static_cast<long long>(F) * D;
  const float* B1 = p.b1 + grp * static_cast<long long>(F);
  const float* B2 = p.b2 + grp * static_cast<long long>(D);
  bf16* OUT = p.out + grp * static_cast<long long>(N) * D;

  const int nk = D / BK;                  // fc1 k-tiles per chunk
  const int nchunks = (F + FC - 1) / FC;
  // the W2 chunk rides with the fc1 k-tiles of iterations [0, w2_iters), so
  // the last STAGES-1 groups of a chunk (the next chunk's W1 prefetch) need
  // not land before its fc2
  const int w2_iters = max(1, nk - (STAGES - 1));
  const int w2_step = (W2_PIECES + w2_iters - 1) / w2_iters;

  // start the copies of the next fc1 k-tile (ld_kt of chunk ld_j) into stage st
  int ld_kt = 0, ld_j = 0;
  auto load_w1 = [&](int st) {
    if (ld_j == nchunks) return;
    const int k0 = ld_kt * BK, f0 = ld_j * FC;
    if (++ld_kt == nk) {
      ld_kt = 0;
      ++ld_j;
    }
#pragma unroll
    for (int i = 0; i < W1_PER_THREAD; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (FC / 8), col = (c % (FC / 8)) * 8;
      const bool in = f0 + col + 8 <= F;
      const bf16* src = in ? W1 + static_cast<long long>(k0 + r) * F + f0 + col : W1;
      cp_async16(sW1 + (st * BK + r) * LDW1 + col, src, in);
    }
  };
  // pieces [lo, hi) of W2 chunk j (rows f0.., this block's columns c0..)
  auto load_w2_part = [&](int j, int it) {
    const int lo = it * w2_step, hi = min(lo + w2_step, W2_PIECES);
    const int f0 = j * FC;
    for (int c = lo + tid; c < hi; c += THREADS) {
      const int r = c / (DN / 8), col = (c % (DN / 8)) * 8;
      const bool in = f0 + r < F && c0 + col + 8 <= D;
      const bf16* src = in ? W2 + static_cast<long long>(f0 + r) * D + c0 + col : W2;
      cp_async16(sW2 + r * LDW2 + col, src, in);
    }
  };

  // the x tile goes with the first group; rows past N are zero-filled
  for (int c = tid; c < R * (D / 8); c += THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const bool in = r0 + r < N;
    const bf16* src = in ? X + static_cast<long long>(r0 + r) * D + col : X;
    cp_async16(sX + r * LDX + col, src, in);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_w1(s);
    cp_async_commit();
  }

  // fc1: 2 x 2 warps of 32 x 32 for each half of every k-tile (k-group kg)
  const int kg = warp / 4, wm1 = (warp / 2) % 2, wn1 = warp % 2;
  const int wm2 = warp / 4, wn2 = warp % 4;  // fc2: 2 x 4 warps of 32 x 96
  float acc[2][12][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 12; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  int stage = 0;  // ring stage of the k-tile being consumed
  for (int j = 0; j < nchunks; ++j) {
    const int f0 = j * FC;
    // this chunk's b1 pairs, loaded now so that the epilogue does not wait
    float2 bias1[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = f0 + wn1 * 32 + n * 8 + 2 * t;
      bias1[n] = col < F ? make_float2(B1[col], B1[col + 1]) : make_float2(0.f, 0.f);
    }
    float hacc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) hacc[i][n][0] = hacc[i][n][1] = hacc[i][n][2] = hacc[i][n][3] = 0.f;

    // fc1: h[64, FC] = x[64, D] @ W1[:, chunk], each k-group over half of every k-tile
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // this k-tile has landed
      __syncthreads();  // everyone's copies visible; the previous stage (and,
                        // at kt = 0, the W2 buffer of the last fc2) is free
      load_w1(stage == 0 ? STAGES - 1 : stage - 1);
      if (kt < w2_iters) load_w2_part(j, kt);
      cp_async_commit();  // one group per iteration, empty past the end
      const bf16* wt = sW1 + stage * BK * LDW1;
      stage = stage + 1 == STAGES ? 0 : stage + 1;
      // fragments double-buffered: step s + 1's loads issue before step s's products
      uint32_t af[2][2][4], bfr[2][2][4];
      auto load_frags = [&](int buf, int kk) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(af[buf][i], sX + (wm1 * 32 + i * 16 + lane % 16) * LDX + kt * BK + kk +
                                      (lane / 16) * 8);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ldmatrix_x4_trans(bfr[buf][jp], wt + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDW1 +
                                              wn1 * 32 + jp * 16 + (lane / 16) * 8);
      };
      load_frags(0, kg * 16);
#pragma unroll
      for (int s = 0; s < BK / 32; ++s) {
        if (s + 1 < BK / 32) load_frags((s + 1) % 2, kg * 16 + (s + 1) * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(hacc[i][n], af[s % 2][i], bfr[s % 2][n / 2][(n % 2) * 2],
                     bfr[s % 2][n / 2][(n % 2) * 2 + 1]);
      }
    }

    // the two k-halves meet in shared memory: k-group kg finishes the rows
    // i = kg of every warp tile, h = bf16(GELU(h + b1)) (units past F are 0);
    // selects, not hacc[kg], keep hacc in registers
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(sRed + (wm1 * 32 + (1 - kg) * 16 + g + hr * 8) * LDRED +
                                   wn1 * 32 + n * 8 + 2 * t) =
            kg ? make_float2(hacc[0][n][2 * hr], hacc[0][n][2 * hr + 1])
               : make_float2(hacc[1][n][2 * hr], hacc[1][n][2 * hr + 1]);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = wn1 * 32 + n * 8 + 2 * t;
      const bool in = f0 + col < F;  // F % 8 == 0: col + 1 is in when col is
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wm1 * 32 + kg * 16 + g + hr * 8;
        const float2 other = *reinterpret_cast<const float2*>(sRed + r * LDRED + col);
        const float v0 = kg ? hacc[1][n][2 * hr] : hacc[0][n][2 * hr];
        const float v1 = kg ? hacc[1][n][2 * hr + 1] : hacc[0][n][2 * hr + 1];
        *reinterpret_cast<uint32_t*>(sH + r * LDH + col) =
            in ? pack_bf16(gelu_as(v0 + other.x + bias1[n].x),
                           gelu_as(v1 + other.y + bias1[n].y))
               : 0u;
      }
    }
    // the W2 chunk has landed (only the next chunk's W1 prefetch may still fly)
    if (nk - w2_iters >= STAGES - 1) cp_async_wait<STAGES - 1>(); else cp_async_wait<0>();
    __syncthreads();

    // fc2: out[64, DN] += h[64, FC] @ W2[chunk, c0 : c0 + DN]
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], sH + (wm2 * 32 + i * 16 + lane % 16) * LDH + kk + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < 6; ++jp) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, sW2 + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDW2 +
                                   wn2 * 96 + jp * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = bf16(acc + b2); each thread owns pairs of neighbouring columns
#pragma unroll
  for (int n = 0; n < 12; ++n) {
    const int col = c0 + wn2 * 96 + n * 8 + 2 * t;
    if (col >= D) continue;
    const float bb0 = B2[col], bb1 = B2[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + wm2 * 32 + i * 16 + g + hr * 8;
        if (row >= N) continue;
        *reinterpret_cast<uint32_t*>(OUT + static_cast<long long>(row) * D + col) =
            pack_bf16(acc[i][n][2 * hr] + bb0, acc[i][n][2 * hr + 1] + bb1);
      }
    }
  }
}

}  // namespace

// out[g] = bf16(bf16(GELU(x[g] @ w1[g] + b1[g])) @ w2[g] + b2[g]):
// x, out [G,N,D] bf16; w1 [G,D,F], w2 [G,F,D] bf16; b1 [G,F], b2 [G,D] f32.
// D % 128 == 0 and D <= 768; F % 8 == 0.  One launch.
extern "C" int mlp(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int G, int N, int D, int F, void* stream) {
  if (D % BK != 0 || D > MAX_D || F % 8 != 0 || F <= 0 || N <= 0 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  MlpArgs p{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
            static_cast<const float*>(b1), static_cast<const bf16*>(w2),
            static_cast<const float*>(b2), static_cast<bf16*>(out), N, D, F};
  dim3 grid((D + DN - 1) / DN, (N + R - 1) / R, G);
  mlp_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
