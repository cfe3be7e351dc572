// The two bf16 block kernels of the folded (eval/serving) transformer block.
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
// weights stream through it and the work is split where a whole row is needed:
//   fused_ln_qkv   = row statistics (f32 mean and variance of each row over
//                    all D columns, one warp per row, the row read once), then
//                    one mma.sync GEMM whose prologue normalises each A tile in
//                    shared memory and casts it to bf16, and whose epilogue
//                    adds the f32 bias and writes bf16 (0.56 ms, PERF.md).
//   fused_out_mlp  = four launches, three on the persistent wgmma + TMA core
//                    of hopper_gemm.cuh:
//                    1. out_proj: attn @ Wo, epilogue x2 = x + (acc + bo) in
//                       f32 (the TPU kernel never rounds x2 to bf16), stored
//                       by TMA in [64][64] sub-tiles; 128 x 192 tiles (788
//                       tiles at G=1: 6 even waves on 132 SMs);
//                    2. LN2 row pass: y = bf16(LN(x2)), one warp per row with
//                       the two-pass f32 statistics, which is exactly what the
//                       TPU kernel feeds fc1 (y.astype(dt));
//                    3. fc1 = the fused MLP's fc1 (fused_mlp.cu): y @ W1,
//                       epilogue h = bf16(GELU_erf(acc + b1)) with the
//                       Abramowitz-Stegun erf the TPU kernel uses; 128 x 256;
//                    4. fc2: h @ W2, epilogue out = bf16(x2 + (acc + b2));
//                       128 x 192.
//                  A LayerNorm prologue cannot sit between a TMA load and a
//                  wgmma that reads shared memory, so y (38.7 MB) and h
//                  ([T, F] bf16, 155 MB) go through device memory once each,
//                  written once and read once.  Step 1 alone is also exported
//                  as out_proj: the bf16 out-projection of the mixed int8 plan
//                  (fused_block_int8.cu).
// The LN1+QKV GEMM: 128x128x32 block tiles, 8 warps of 64x32, mma.sync
// m16n8k16 with f32 accumulators, a 4-stage cp.async pipeline for the raw x
// and W tiles and ldmatrix fragment loads from padded rows.  Each raw x tile
// is normalised in shared memory into one of two alternating bf16 tiles, one
// tile ahead of the MMAs, so the normalisation of tile k+1 overlaps other
// warps' products on tile k.  Computing the statistics once per row, not once
// per (row tile, column tile), is what keeps the prologue cheap.
#include "hopper_gemm.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 4;      // cp.async pipeline depth
constexpr int LDA = BK + 8;    // 80 B rows: conflict-free ldmatrix
constexpr int LDB = BN + 8;    // 272 B rows
constexpr int MAX_K = 32 * 8 * 4;  // a row pass holds a row of <= 1024 in registers

struct GemmArgs {
  const bf16* a;  long long a_g;    // x [G, M, K] bf16
  const bf16* w;  long long w_g;    // W [G, K, N] bf16
  const float* bias; long long bias_g;  // [G, N] f32
  const float* ln_s; const float* ln_b;  // LN over K (prologue) ...
  const float2* stats;                   // ... with (mean, rstd) per row [G, M]
  bf16* out;      long long out_g;   // [G, M, N] bf16
  int M, N, K;
};

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

// LN1 statistics of x, one warp per row; the GEMM prologue normalises with them
__global__ void __launch_bounds__(256) row_stats_kernel(const bf16* __restrict__ x,
                                                        float2* __restrict__ stats, int rows,
                                                        int K, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float v[4][8];
  const float2 st = load_row_stats<bf16>(x + static_cast<long long>(row) * K, K, eps, lane, v);
  if (lane == 0) stats[row] = st;
}

// LN2 of the out-projection's f32 rows into fc1's bf16 operand, one warp per
// row: y = bf16(((x2 - mu) * rstd) * s + b)
__global__ void __launch_bounds__(256) ln_rows_kernel(const float* __restrict__ x2,
                                                      const float* __restrict__ ln_s,
                                                      const float* __restrict__ ln_b,
                                                      bf16* __restrict__ y, int rows, int K,
                                                      float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float v[4][8];
  const float2 st = load_row_stats<float>(x2 + static_cast<long long>(row) * K, K, eps, lane, v);
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

// Shared memory of the LN1 GEMM: raw bf16 x tiles land in `raw` (one per
// stage) and are normalised into two alternating bf16 `a` tiles; W tiles one
// per stage; the per-row (mean, rstd) and the per-column LN scale and bias.
constexpr int LDR = BK + 8;  // 16-B pad per raw row
constexpr int SMEM_RAW = STAGES * BM * LDR * 2;
constexpr int SMEM_A = 2 * BM * LDA * 2;
constexpr int SMEM_B = STAGES * BK * LDB * 2;
constexpr int SMEM_LN = (2 * BM + 2 * MAX_K) * 4;
constexpr int SMEM_BYTES = SMEM_RAW + SMEM_A + SMEM_B + SMEM_LN;

// out = bf16(LN(x) @ W + bias) with the LN applied to each A tile in shared memory
__global__ void __launch_bounds__(THREADS, 2) ln_gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sRaw = reinterpret_cast<bf16*>(smem);
  bf16* sA = reinterpret_cast<bf16*>(smem + SMEM_RAW);
  bf16* sB = reinterpret_cast<bf16*>(smem + SMEM_RAW + SMEM_A);
  float* s_mu = reinterpret_cast<float*>(smem + SMEM_RAW + SMEM_A + SMEM_B);
  float* s_rstd = s_mu + BM;
  float* s_lns = s_rstd + BM;
  float* s_lnb = s_lns + MAX_K;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int g = lane / 4, t = lane % 4;
  const int bn = blockIdx.x * BN, bm = blockIdx.y * BM, grp = blockIdx.z;
  const int M = p.M, N = p.N, K = p.K;
  const bf16* A = p.a + grp * p.a_g;
  const bf16* W = p.w + grp * p.w_g;
  const int nk = (K + BK - 1) / BK;

  // start the copies of k-tile kt into pipeline stage st
  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    if (kt < nk) {
#pragma unroll
      for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const bool in = bm + r < M && k0 + col + 8 <= K;
        const bf16* src = in ? A + static_cast<long long>(bm + r) * K + k0 + col : A;
        cp_async16(sRaw + (st * BM + r) * LDR + col, src, in);
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

  // normalise raw k-tile kt into bf16 A buffer kt % 2: ((x - mu) * rstd) * s + b
  auto normalise = [&](int kt) {
    const int k0 = kt * BK, st = kt % STAGES;
    bf16* dst = sA + (kt & 1) * BM * LDA;
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      float v[8];
      if (k0 + col + 8 <= K) {
        load8<bf16>(sRaw + (st * BM + r) * LDR + col, v);
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

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    cp_async_wait<STAGES - 3>();  // k-tile kt+1 has landed (kt is normalised)
    __syncthreads();  // everyone's copies visible; stage kt-1 and A buffer (kt+1)%2 free
    load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    const bf16* a_tile = sA + (kt & 1) * BM * LDA;
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
    if (kt + 1 < nk) normalise(kt + 1);
  }
  cp_async_wait<0>();

  // epilogue: each thread owns pairs of neighbouring columns
  const float* bias = p.bias + grp * p.bias_g;
  bf16* out = p.out + grp * p.out_g;
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
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N + col) =
            pack_bf16(acc[i][j][2 * hr] + b0, acc[i][j][2 * hr + 1] + b1);
      }
    }
  }
}

bool row_pass_takes(int K) { return K > 0 && K <= MAX_K && K % 8 == 0; }

}  // namespace

// qkv[g] = bf16(LN(x[g]) @ w[g] + b[g]);  x [G,T,D] bf16, w [G,D,O] bf16,
// ln_s/ln_b [D] f32, b [G,O] f32, out [G,T,O] bf16; stats [G*T] float2 is
// caller-allocated scratch.  Two launches: row statistics, then the GEMM.
extern "C" int ln_qkv(const void* x, const void* ln_s, const void* ln_b,
                      const void* w, const void* b, void* stats, void* out, int G,
                      int T, int D, int O, float eps, void* stream) {
  if (!row_pass_takes(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* rs = static_cast<float2*>(stats);
  row_stats_kernel<<<(G * T + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x), rs, G * T, D,
                                                     eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  GemmArgs p{};
  p.a = static_cast<const bf16*>(x);  p.a_g = static_cast<long long>(T) * D;
  p.w = static_cast<const bf16*>(w);  p.w_g = static_cast<long long>(D) * O;
  p.bias = static_cast<const float*>(b);  p.bias_g = O;
  p.ln_s = static_cast<const float*>(ln_s);  p.ln_b = static_cast<const float*>(ln_b);
  p.stats = rs;
  p.out = static_cast<bf16*>(out);  p.out_g = static_cast<long long>(T) * O;
  p.M = T;  p.N = O;  p.K = D;
  if ((e = cudaFuncSetAttribute(ln_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_BYTES)) != cudaSuccess)
    return static_cast<int>(e);
  ln_gemm_kernel<<<dim3((O + BN - 1) / BN, (T + BM - 1) / BM, G), THREADS, SMEM_BYTES, st>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  ln_rows_kernel<<<(G * T + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(x2), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(y), G * T, D, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const hgemm::Params fc1{T, F, D, G, static_cast<const float*>(b1)};
  e = hgemm::gemm<hgemm::Bf16Op, hgemm::Bf16Out<hgemm::BIAS_GELU>, 128, 256, 2, 3>(y, w1, h, fc1,
                                                                                    st);
  if (e != 0) return e;
  const hgemm::Params fc2{T, D, F, G, static_cast<const float*>(b2), x2};
  return static_cast<int>(
      hgemm::gemm<hgemm::Bf16Op, hgemm::Bf16Out<hgemm::RES_X2>, 128, 192, 2, 4>(h, w2, out, fc2, st));
}
