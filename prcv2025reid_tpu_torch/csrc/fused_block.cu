// The two bf16 block kernels of the folded (eval/serving) transformer block,
// built on one hand-written tensor-core GEMM core with fused prologues and
// epilogues.
//
// Replaces: prcv2025reid_tpu/ops/fused_block.py::_ln_qkv_kernel_bf16
// (fused_ln_qkv, quant="bf16") and ::_out_mlp_kernel_bf16 (fused_out_mlp,
// quant="bf16").
//
// Bound on an H100 (ViT-B/16, G=1, T=25,216 rows): LN1+QKV is 89.2 GFLOP
// (~90 us at 989 TFLOP/s bf16) against 158 MB, out-proj+LN2+MLP 267.7 GFLOP
// (~271 us); both are compute-bound.  The TPU design keeps every weight and a
// whole row tile resident in ~15 MB of VMEM; a Hopper block has 227 KB of
// shared memory, so the weights are streamed instead:
//   fused_ln_qkv   = row statistics (f32 mean and variance of each row over
//                    all D columns, one warp per row, the row read once), then
//                    one GEMM whose prologue normalises each A tile in shared
//                    memory and casts it to bf16, and whose epilogue adds the
//                    f32 bias and writes bf16.
//   fused_out_mlp  = the same pieces, four launches:
//                    1. attn @ Wo, epilogue x2 = x + (acc + bo), kept in f32
//                       (the TPU kernel never rounds x2 to bf16);
//                    2. row statistics of x2;
//                    3. LN2 prologue on x2, x2n @ W1, epilogue
//                       h = bf16(GELU_erf(acc + b1)) with the Abramowitz-Stegun
//                       erf the TPU kernel uses;
//                    4. h @ W2, epilogue out = bf16(x2 + (acc + b2)).
//                  Step 1 alone is also exported as out_proj: the bf16
//                  out-projection of the mixed int8 plan (fused_block_int8.cu).
//                  The [T, F] round trip of h through device memory is the cost
//                  of this version.
// The GEMM core: 128x128x32 block tiles, 8 warps of 64x32, mma.sync m16n8k16
// with f32 accumulators, a 3- or 4-stage cp.async pipeline for the A and W
// tiles and ldmatrix fragment loads from padded rows.  With the LayerNorm
// prologue each raw A tile (bf16 x, or f32 x2) is normalised in shared memory
// into one of two alternating bf16 tiles, one tile ahead of the MMAs, so the
// normalisation of tile k+1 overlaps other warps' products on tile k.  Computing the statistics once per row, not once
// per (row tile, column tile), is what keeps the prologue cheap.
#include "common.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;   // 80 B rows: conflict-free ldmatrix
constexpr int LDB = BN + 8;   // 272 B rows

enum Epilogue { EPI_BIAS = 0, EPI_RES_F32 = 1, EPI_GELU = 2, EPI_RES_BF16 = 3 };

struct GemmArgs {
  const void* a;  long long a_g;    // A [G, M, K] (bf16, or f32 with LN)
  const bf16* w;  long long w_g;    // W [G, K, N] bf16
  const float* bias; long long bias_g;  // [G, N] f32
  const float* ln_s; const float* ln_b;  // LN over K (prologue) ...
  const float2* stats;                   // ... with (mean, rstd) per row [G, M]
  const void* res; long long res_g;  // residual [G, M, N]: bf16 or f32
  void* out;      long long out_g;   // [G, M, N]: bf16 or f32
  int M, N, K;
};

template <typename AT>
__device__ __forceinline__ void load8(const AT* p, float (&v)[8]);

template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, float (&v)[8]) {
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

// f32 LayerNorm statistics, one warp per row: mean, then the mean squared
// deviation (two passes over the row held in registers), rstd = 1/sqrt(var+eps).
// Each row is read once; the GEMM prologue then normalises with them.
constexpr int STATS_MAX_K = 32 * 8 * 4;

template <typename AT>
__global__ void __launch_bounds__(256) row_stats_kernel(const AT* __restrict__ x,
                                                        float2* __restrict__ stats,
                                                        int rows, int K, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const AT* xr = x + static_cast<long long>(row) * K;
  float v[4][8], sum = 0.f;
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
  if (lane == 0) stats[row] = make_float2(mu, rsqrtf(sq / K + eps));
}

template <typename AT>
cudaError_t run_stats(const void* x, float2* stats, int rows, int K, float eps,
                      cudaStream_t stream) {
  if (K > STATS_MAX_K || K % 8 != 0) return cudaErrorInvalidValue;
  row_stats_kernel<AT><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const AT*>(x), stats, rows, K, eps);
  return cudaGetLastError();
}

template <typename AT, bool LN>
struct Smem {
  // cp.async pipeline depth (the f32 raw tiles of the LN2 GEMM leave room for 3)
  static constexpr int STAGES = (LN && sizeof(AT) == 2) ? 4 : 3;
  // LN: raw A tiles (bf16 x or f32 x2) land in `raw` and are normalised into
  // two alternating bf16 `a` tiles; no LN: one bf16 `a` tile per stage
  static constexpr int LDR = BK + 16 / static_cast<int>(sizeof(AT));  // 16-B pad per row
  static constexpr int RAW = LN ? STAGES * BM * LDR * static_cast<int>(sizeof(AT)) : 0;
  static constexpr int A = (LN ? 2 : STAGES) * BM * LDA * 2;
  static constexpr int B = STAGES * BK * LDB * 2;
  // LN: per-row (mean, rstd) and the per-column scale and bias
  static constexpr int LNP = LN ? (2 * BM + 2 * STATS_MAX_K) * 4 : 0;
  static constexpr int BYTES = RAW + A + B + LNP;
};

template <typename AT, bool LN, int EPI>
__global__ void __launch_bounds__(THREADS, 2) gemm_kernel(GemmArgs p) {
  using SM = Smem<AT, LN>;
  constexpr int STAGES = SM::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  AT* sRaw = reinterpret_cast<AT*>(smem);
  bf16* sA = reinterpret_cast<bf16*>(smem + SM::RAW);
  bf16* sB = reinterpret_cast<bf16*>(smem + SM::RAW + SM::A);
  float* s_mu = reinterpret_cast<float*>(smem + SM::RAW + SM::A + SM::B);
  float* s_rstd = s_mu + BM;
  float* s_lns = s_rstd + BM;
  float* s_lnb = s_lns + STATS_MAX_K;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int g = lane / 4, t = lane % 4;
  const int bn = blockIdx.x * BN, bm = blockIdx.y * BM, grp = blockIdx.z;
  const int M = p.M, N = p.N, K = p.K;
  const AT* A = static_cast<const AT*>(p.a) + grp * p.a_g;
  const bf16* W = p.w + grp * p.w_g;
  const int nk = (K + BK - 1) / BK;

  // start the copies of k-tile kt into pipeline stage st
  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    if (kt < nk) {
      constexpr int EPC = 16 / static_cast<int>(sizeof(AT));  // A elements per 16 B
      constexpr int ACH = BM * BK / EPC;                       // A chunks per tile
#pragma unroll
      for (int i = 0; i < ACH / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BK / EPC), col = (c % (BK / EPC)) * EPC;
        const bool in = bm + r < M && k0 + col + EPC <= K;
        const AT* src = in ? A + static_cast<long long>(bm + r) * K + k0 + col : A;
        void* dst = LN ? static_cast<void*>(sRaw + (st * BM + r) * SM::LDR + col)
                       : static_cast<void*>(sA + (st * BM + r) * LDA + col);
        cp_async16(dst, src, in);
      }
#pragma unroll
      for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const bool in = k0 + r < K && bn + col + 8 <= N;
        const bf16* src = in ? W + static_cast<long long>(k0 + r) * N + bn + col : W;
        cp_async16(sB + (st * BK + r) * LDB + col, src, in);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };

  // LN: normalise raw k-tile kt into bf16 A buffer kt % 2: ((x - mu) * rstd) * s + b
  auto normalise = [&](int kt) {
    const int k0 = kt * BK, st = kt % STAGES;
    bf16* dst = sA + (kt & 1) * BM * LDA;
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      float v[8];
      if (k0 + col + 8 <= K) {
        load8<AT>(sRaw + (st * BM + r) * SM::LDR + col, v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = ((v[e] - s_mu[r]) * s_rstd[r]) * s_lns[k0 + col + e] + s_lnb[k0 + col + e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      *reinterpret_cast<uint4*>(dst + r * LDA + col) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  };

  // the first STAGES-1 tiles are in flight while the LN parameters load
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s, s);
  if (LN) {
    for (int r = tid; r < BM; r += THREADS) {
      const float2 st = bm + r < M ? p.stats[grp * static_cast<long long>(M) + bm + r]
                                   : make_float2(0.f, 0.f);
      s_mu[r] = st.x;
      s_rstd[r] = st.y;
    }
    for (int c = tid; c < K; c += THREADS) {
      s_lns[c] = p.ln_s[c];
      s_lnb[c] = p.ln_b[c];
    }
    cp_async_wait<STAGES - 2>();  // k-tile 0 has landed
    __syncthreads();
    normalise(0);
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    // no LN: k-tile kt has landed; LN: k-tile kt+1 has landed (kt is normalised)
    if (LN) cp_async_wait<STAGES - 3>(); else cp_async_wait<STAGES - 2>();
    __syncthreads();  // everyone's copies visible; stage kt-1 and A buffer (kt+1)%2 free
    load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    const bf16* a_tile = sA + (LN ? (kt & 1) : st) * BM * LDA;
    const bf16* b_tile = sB + st * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a_tile + (wm * 64 + i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4_trans(bfr[jp], b_tile + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDB +
                                       wn * 32 + jp * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
    }
    // the next tile is normalised while other warps still multiply this one
    if (LN && kt + 1 < nk) normalise(kt + 1);
  }
  cp_async_wait<0>();

  // epilogue: each thread owns pairs of neighbouring columns
  const float* bias = p.bias + grp * p.bias_g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = bn + wn * 32 + j * 8 + 2 * t;
      if (col >= N) continue;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = bm + wm * 64 + i * 16 + g + hr * 8;
        if (row >= M) continue;
        const long long off = static_cast<long long>(row) * N + col;
        float v0 = acc[i][j][2 * hr] + b0, v1 = acc[i][j][2 * hr + 1] + b1;
        if (EPI == EPI_BIAS) {
          bf16* out = static_cast<bf16*>(p.out) + grp * p.out_g;
          *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(v0, v1);
        } else if (EPI == EPI_RES_F32) {
          const bf16* res = static_cast<const bf16*>(p.res) + grp * p.res_g;
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + off));
          float* out = static_cast<float*>(p.out) + grp * p.out_g;
          *reinterpret_cast<float2*>(out + off) = make_float2(x.x + v0, x.y + v1);
        } else if (EPI == EPI_GELU) {
          bf16* out = static_cast<bf16*>(p.out) + grp * p.out_g;
          *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(gelu_as(v0), gelu_as(v1));
        } else {  // EPI_RES_BF16
          const float* res = static_cast<const float*>(p.res) + grp * p.res_g;
          const float2 x = *reinterpret_cast<const float2*>(res + off);
          bf16* out = static_cast<bf16*>(p.out) + grp * p.out_g;
          *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(x.x + v0, x.y + v1);
        }
      }
    }
  }
}

template <typename AT, bool LN, int EPI>
cudaError_t run_gemm(const GemmArgs& p, int G, cudaStream_t stream) {
  constexpr int bytes = Smem<AT, LN>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<AT, LN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, G);
  gemm_kernel<AT, LN, EPI><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// qkv[g] = bf16(LN(x[g]) @ w[g] + b[g]);  x [G,T,D] bf16, w [G,D,O] bf16,
// ln_s/ln_b [D] f32, b [G,O] f32, out [G,T,O] bf16; stats [G*T] float2 is
// caller-allocated scratch.  Two launches: row statistics, then the GEMM.
extern "C" int ln_qkv(const void* x, const void* ln_s, const void* ln_b,
                      const void* w, const void* b, void* stats, void* out, int G,
                      int T, int D, int O, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  float2* rs = static_cast<float2*>(stats);
  if ((e = run_stats<bf16>(x, rs, G * T, D, eps, st)) != cudaSuccess) return e;
  GemmArgs p{};
  p.a = x;  p.a_g = static_cast<long long>(T) * D;
  p.w = static_cast<const bf16*>(w);  p.w_g = static_cast<long long>(D) * O;
  p.bias = static_cast<const float*>(b);  p.bias_g = O;
  p.ln_s = static_cast<const float*>(ln_s);  p.ln_b = static_cast<const float*>(ln_b);
  p.stats = rs;
  p.out = out;  p.out_g = static_cast<long long>(T) * O;
  p.M = T;  p.N = O;  p.K = D;
  return static_cast<int>(run_gemm<bf16, true, EPI_BIAS>(p, G, st));
}

// x2[g] = x[g] + (attn[g] @ wo[g] + bo[g]) in f32: the out-projection alone,
// the first step of the mixed int8 plan (csrc/fused_block_int8.cu runs the
// rest).  attn, x [G,T,D] bf16; wo [G,D,D] bf16; bo [G,D] f32; x2 [G,T,D] f32.
extern "C" int out_proj(const void* attn, const void* x, const void* wo, const void* bo,
                        void* x2, int G, int T, int D, void* stream) {
  const long long TD = static_cast<long long>(T) * D;
  GemmArgs p{};
  p.a = attn;  p.a_g = TD;
  p.w = static_cast<const bf16*>(wo);  p.w_g = static_cast<long long>(D) * D;
  p.bias = static_cast<const float*>(bo);  p.bias_g = D;
  p.res = x;  p.res_g = TD;
  p.out = x2;  p.out_g = TD;
  p.M = T;  p.N = D;  p.K = D;
  return static_cast<int>(
      run_gemm<bf16, false, EPI_RES_F32>(p, G, static_cast<cudaStream_t>(stream)));
}

// out[g] = bf16(x2 + GELU(LN(x2) @ w1[g] + b1[g]) @ w2[g] + b2[g]) with
// x2 = x[g] + attn[g] @ wo[g] + bo[g] in f32.  attn, x [G,T,D] bf16; wo
// [G,D,D], w1 [G,D,F], w2 [G,F,D] bf16; bo, b1, b2 [G,*] f32; ln [D] f32.
// x2 [G,T,D] f32, stats [G*T] float2 and h [G,T,F] bf16 are caller-allocated
// scratch.  Four launches: out-proj, row statistics of x2, fc1, fc2.
extern "C" int out_mlp(const void* attn, const void* x, const void* wo,
                       const void* bo, const void* ln_s, const void* ln_b,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, void* x2, void* stats, void* h, void* out,
                       int G, int T, int D, int F, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long TD = static_cast<long long>(T) * D, TF = static_cast<long long>(T) * F;
  float2* rs = static_cast<float2*>(stats);
  cudaError_t e;

  if ((e = static_cast<cudaError_t>(out_proj(attn, x, wo, bo, x2, G, T, D, stream))) !=
      cudaSuccess)
    return e;
  if ((e = run_stats<float>(x2, rs, G * T, D, eps, st)) != cudaSuccess) return e;

  GemmArgs p2{};
  p2.a = x2;  p2.a_g = TD;
  p2.w = static_cast<const bf16*>(w1);  p2.w_g = static_cast<long long>(D) * F;
  p2.bias = static_cast<const float*>(b1);  p2.bias_g = F;
  p2.ln_s = static_cast<const float*>(ln_s);  p2.ln_b = static_cast<const float*>(ln_b);
  p2.stats = rs;
  p2.out = h;  p2.out_g = TF;
  p2.M = T;  p2.N = F;  p2.K = D;
  if ((e = run_gemm<float, true, EPI_GELU>(p2, G, st)) != cudaSuccess) return e;

  GemmArgs p3{};
  p3.a = h;  p3.a_g = TF;
  p3.w = static_cast<const bf16*>(w2);  p3.w_g = static_cast<long long>(F) * D;
  p3.bias = static_cast<const float*>(b2);  p3.bias_g = D;
  p3.res = x2;  p3.res_g = TD;
  p3.out = out;  p3.out_g = TD;
  p3.M = T;  p3.N = D;  p3.K = F;
  return static_cast<int>(run_gemm<bf16, false, EPI_RES_BF16>(p3, G, st));
}
