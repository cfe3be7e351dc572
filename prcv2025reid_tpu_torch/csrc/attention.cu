// Fused multi-head attention forward for the ViT trunk: softmax(QK^T/sqrt(Dh))V
// with the [S, S] scores kept on chip.
//
// Replaces: prcv2025reid_tpu/ops/pallas_attention.py::_attn_kernel_batched_heads
// (pallas_mha kernel_version=2) and ::_attn_kernel (kernel_version=1).  The TPU
// kernels differ only in their grid split, so one Hopper kernel serves both.
//
// Bound on an H100 (vision shape B=128, H=12, S=197, Dh=64): 15.3 GFLOP of
// products against 155 MB of q/k/v/out, so it is memory-bound (~46 us at
// 3.35 TB/s).  Design, so that each byte crosses device memory once and the
// loads run under the compute:
//   - a persistent grid walks the (batch, head) pairs; each pair's Q, K and V
//     (S <= 16 KCH rows of 64 bf16, one 128-byte swizzled row each) are
//     staged ONCE, by TMA (one 4-d box per operand, so the model's strided
//     views of its fused QKV projection need no copies; rows >= S are zero
//     filled), into one of two stages: the next pair's loads are in flight
//     while the warps compute on this one (a `full` mbarrier per stage
//     counts the bytes; the warp that finishes a pair's last strip refills
//     its stage with the pair after next, so no wait-all comes before
//     compute and no warp is kept back for loading: 8 warps, 2 on each of
//     the SM's 4 schedulers, up to 255 registers each);
//   - the pair's nstrips = ceil(S / 16) query strips of 16 rows are shared
//     among the warps through one sequence of (pair, strip) items per block,
//     so no warp idles at a pair's end and no strip stages K or V again.  A
//     block has min(8, nstrips) warps, so every warp has an item in every
//     pair: when it waits for pair i it has finished one of pair i - 2, so
//     the stage's barrier is in pair i's phase and its parity bit cannot
//     alias pair i - 2's;
//   - each warp keeps its strip's 16 rows of f32 scores for ALL keys in
//     registers (S <= 256): scores, max-subtracted softmax and P never touch
//     device memory.  QK^T and PV run on the tensor cores (mma.sync m16n8k16,
//     f32 accumulation; ldmatrix from the swizzled tiles is conflict-free).
//     As in the TPU kernel, P is normalised in f32 and only then cast to bf16
//     before PV; the exponential is ex2 of logits pre-scaled by log2(e) and
//     the normalisation a multiply by 1 / l, each a few f32 ulps, far below
//     P's bf16 rounding;
//   - keys >= S (and above the diagonal when causal) are masked by index, so
//     the inputs need no padding; the strip's output goes through its own Q
//     rows in shared memory and leaves as whole 128-byte rows.
// q/k/v/out are addressed through element strides (batch, head, sequence).
#include "common.cuh"
#include "hopper.cuh"

using namespace port;
using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;                      // head dim: one 128-byte row
constexpr int WARPS = 8;  // at most; a block has min(WARPS, ceil(S / 16))
constexpr int THREADS = WARPS * 32;

struct Strides {
  long long b, h, s;  // element strides; the head dim is contiguous
};

template <int KCH>  // rows staged in chunks of 16: S <= 16 * KCH
struct AttnCfg {
  static constexpr int ROWS = 16 * KCH;
  static constexpr int TILE = ROWS * DH * 2;  // bytes of one operand
  static constexpr int STAGE = 3 * TILE;      // q, k, v
  static constexpr int SMEM = 2 * STAGE + 4 * 8 + 1024;  // + 2 mbarriers, 2 counters, alignment
};

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// TMA coordinates of a head's box: the head dim and the sequence at 0, h and b
// in the map's dims `slots` names (2 bits each: head, batch)
__device__ __forceinline__ void head_coords(int slots, int h, int b, int& c1, int& c2, int& c3) {
  const int sh = slots & 3, sb = (slots >> 2) & 3;
  c1 = (sh == 1 ? h : 0) + (sb == 1 ? b : 0);
  c2 = (sh == 2 ? h : 0) + (sb == 2 ? b : 0);
  c3 = (sh == 3 ? h : 0) + (sb == 3 ? b : 0);
}

// start the TMA fill of a stage (at dst, counted on its `full` barrier) with
// pair p's q, k, v
template <int KCH>
__device__ __forceinline__ void fill_stage(unsigned char* dst, uint64_t* full,
                                           const CUtensorMap* map_q, const CUtensorMap* map_k,
                                           const CUtensorMap* map_v, int slots, int p, int H) {
  mbar_arrive_expect_tx(full, AttnCfg<KCH>::STAGE);
  const int b = p / H, h = p - b * H;
  int c1, c2, c3;
  head_coords(slots, h, b, c1, c2, c3);
  tma_load_4d(dst, map_q, full, 0, c1, c2, c3);
  head_coords(slots >> 4, h, b, c1, c2, c3);
  tma_load_4d(dst + AttnCfg<KCH>::TILE, map_k, full, 0, c1, c2, c3);
  head_coords(slots >> 8, h, b, c1, c2, c3);
  tma_load_4d(dst + 2 * AttnCfg<KCH>::TILE, map_v, full, 0, c1, c2, c3);
}

template <int KCH>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, int slots, bf16* __restrict__ o,
                Strides os, int BH, int H, int S, float scale_log2, int causal) {
  using C = AttnCfg<KCH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + 2 * C::STAGE);
  int* done = reinterpret_cast<int*>(full + 2);  // strips finished in each stage
  const int nstrips = (S + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    fence_barrier_init();
    // this block's pairs 0 and 1 into stages 0 and 1
    for (int s = 0; s < 2 && blockIdx.x + s * gridDim.x < BH; ++s)
      fill_stage<KCH>(stages + s * C::STAGE, &full[s], &map_q, &map_k, &map_v, slots,
                      blockIdx.x + s * gridDim.x, H);
  }
  __syncthreads();

  // item f = (pair i, strip j) of the block's sequence; pair i sits in stage i % 2
  const int g = lane / 4, t = lane % 4;
  for (int f = warp;; f += warps) {
    const int i = f / nstrips, j = f - i * nstrips;
    const int p = blockIdx.x + i * gridDim.x;
    if (p >= BH) break;
    const int st = i & 1;
    mbar_wait(&full[st], (i >> 1) & 1);
    unsigned char* sQ = stages + st * C::STAGE;
    const unsigned char* sK = sQ + C::TILE;
    const unsigned char* sV = sQ + 2 * C::TILE;
    const int r0 = j * 16;

    uint32_t qf[DH / 16][4];
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
      ldmatrix_x4(qf[kc], sQ + swz(r0 + lane % 16, kc * 2 + lane / 16));

    // scores: n8 block nb covers keys nb*8 .. nb*8+7
    float s[2 * KCH][4];
#pragma unroll
    for (int nb = 0; nb < 2 * KCH; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KCH; ++jj) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + swz(jj * 16 + lane % 8 + (lane / 16) * 8, kc * 2 + (lane / 8) % 2));
        mma_bf16(s[2 * jj], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // mask, f32 softmax over each row (a row lives on the 4 lanes of a quad)
    const int row0 = r0 + g, row1 = row0 + 8;
    float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
    for (int nb = 0; nb < 2 * KCH; ++nb) {
      if (causal || nb * 8 + 8 > S) {  // the same branch for the whole warp
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * t + (e & 1);
          if (col >= S || (causal && col > (e < 2 ? row0 : row1))) s[nb][e] = -1e30f;
        }
      }
      m0 = fmaxf(m0, fmaxf(s[nb][0], s[nb][1]));
      m1 = fmaxf(m1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // exp((s - m) / sqrt(Dh)) = 2^(s c - m c), c = log2(e) / sqrt(Dh); masked keys give 0
    const float mc0 = m0 * scale_log2, mc1 = m1 * scale_log2;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2 * KCH; ++nb) {
      s[nb][0] = ex2(fmaf(s[nb][0], scale_log2, -mc0));
      s[nb][1] = ex2(fmaf(s[nb][1], scale_log2, -mc0));
      s[nb][2] = ex2(fmaf(s[nb][2], scale_log2, -mc1));
      s[nb][3] = ex2(fmaf(s[nb][3], scale_log2, -mc1));
      l0 += s[nb][0] + s[nb][1];
      l1 += s[nb][2] + s[nb][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;

    // PV: the normalised scores of key chunk jj, cast to bf16, are the A fragment
    float acc[DH / 8][4];
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KCH; ++jj) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * jj][0] * inv0, s[2 * jj][1] * inv0);
      pa[1] = pack_bf16(s[2 * jj][2] * inv1, s[2 * jj][3] * inv1);
      pa[2] = pack_bf16(s[2 * jj + 1][0] * inv0, s[2 * jj + 1][1] * inv0);
      pa[3] = pack_bf16(s[2 * jj + 1][2] * inv1, s[2 * jj + 1][3] * inv1);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + swz(jj * 16 + lane % 8 + ((lane / 8) % 2) * 8, dp * 2 + lane / 16));
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }

    // the strip's output through its own Q rows (no other warp reads them),
    // then out as 128-byte rows
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(sQ + swz(row0, nb) + 4 * t) = pack_bf16(acc[nb][0], acc[nb][1]);
      *reinterpret_cast<uint32_t*>(sQ + swz(row1, nb) + 4 * t) = pack_bf16(acc[nb][2], acc[nb][3]);
    }
    __syncwarp();
    const int b = p / H, h = p - b * H;
    bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = r0 + it * 4 + lane / 8, c = lane % 8;
      if (r < S)
        *reinterpret_cast<uint4*>(ob + r * os.s + c * 8) =
            *reinterpret_cast<const uint4*>(sQ + swz(r, c));
    }
    fence_proxy_async();  // these reads and writes come before the stage's next TMA fill
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[st], 1) == nstrips - 1) {  // the pair's last strip: refill
        done[st] = 0;
        __threadfence_block();
        const int pn = p + 2 * gridDim.x;
        if (pn < BH)
          fill_stage<KCH>(sQ, &full[st], &map_q, &map_k, &map_v, slots, pn, H);
      }
    }
  }
}

// The TMA map of one operand, [B, H, S, 64] through element strides: dim 0 the
// head dim, then sequence, head and batch ordered by stride; the box is the
// whole (zero-filled past S) head.  *slots gets the dims of head and batch.
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int H, int S, Strides st,
                     int rows, int* slots) {
  const long long ext[3] = {S, H, B}, str[3] = {st.s, st.h, st.b};
  int order[3] = {0, 1, 2};
  for (int a = 1; a < 3; ++a)
    for (int c = a; c > 0 && str[order[c]] < str[order[c - 1]]; --c) {
      const int tmp = order[c];
      order[c] = order[c - 1];
      order[c - 1] = tmp;
    }
  cuuint64_t dims[4] = {DH}, strides[3];
  cuuint32_t box[4] = {DH};
  *slots = 0;
  for (int d = 0; d < 3; ++d) {
    const int which = order[d];
    dims[d + 1] = static_cast<cuuint64_t>(ext[which]);
    strides[d] = static_cast<cuuint64_t>(str[which]) * 2;
    box[d + 1] = which == 0 ? rows : 1;
    if (which == 1) *slots |= d + 1;
    if (which == 2) *slots |= (d + 1) << 2;
  }
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims, strides, box);
}

template <int KCH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int S,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   cudaStream_t stream) {
  using C = AttnCfg<KCH>;
  CUtensorMap map_q, map_k, map_v;
  int sq = 0, sk = 0, sv = 0;
  cudaError_t e = head_map(&map_q, q, B, H, S, qs, C::ROWS, &sq);
  if (e == cudaSuccess) e = head_map(&map_k, k, B, H, S, ks, C::ROWS, &sk);
  if (e == cudaSuccess) e = head_map(&map_v, v, B, H, S, vs, C::ROWS, &sv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_fwd_kernel<KCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  // no more warps than strips (the kernel's phase argument needs it)
  const int nstrips = (S + 15) / 16, threads = 32 * (nstrips < WARPS ? nstrips : WARPS);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_fwd_kernel<KCH>, threads,
                                                    C::SMEM);
  if (e != cudaSuccess) return e;
  const int BH = B * H, resident = sms * (per_sm > 0 ? per_sm : 1);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(DH));
  attn_fwd_kernel<KCH><<<BH < resident ? BH : resident, threads, C::SMEM, stream>>>(
      map_q, map_k, map_v, sq | (sk << 4) | (sv << 8), o, os, BH, H, S, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, S, 64] bf16 addressed through element strides (batch,
// head, sequence); the head dim must be contiguous and rows 16-byte aligned.
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int S, long long qb, long long qh,
                        long long qsq, long long kb, long long kh, long long ksq,
                        long long vb, long long vh, long long vsq, long long ob,
                        long long oh, long long osq, int causal, void* stream) {
  const Strides qs{qb, qh, qsq}, ks{kb, kh, ksq}, vs{vb, vh, vsq}, os{ob, oh, osq};
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  bf16* o_ = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (S <= 0 || B <= 0 || H <= 0)
    e = cudaErrorInvalidValue;
  else if (S <= 64)
    e = launch<4>(q_, k_, v_, o_, B, H, S, qs, ks, vs, os, causal, st);
  else if (S <= 128)
    e = launch<8>(q_, k_, v_, o_, B, H, S, qs, ks, vs, os, causal, st);
  else if (S <= 208)
    e = launch<13>(q_, k_, v_, o_, B, H, S, qs, ks, vs, os, causal, st);
  else if (S <= 256)
    e = launch<16>(q_, k_, v_, o_, B, H, S, qs, ks, vs, os, causal, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
