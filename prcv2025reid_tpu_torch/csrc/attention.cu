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
//     (S <= 16 KCH rows of DHP bf16, as DHP / 64 atoms of 128-byte swizzled
//     rows) are staged ONCE, by TMA (one 4-d box per operand and atom, so the
//     model's strided views of its fused QKV projection need no copies; rows
//     >= S are zero filled), into one of two stages (one where two do not
//     fit: DHP = 128 past 128 rows): the next pair's loads are in flight
//     while the warps compute on this one (a `full` mbarrier per stage
//     counts the bytes; the warp that finishes a pair's last strip refills
//     its stage with the pair after next, so no wait-all comes before
//     compute and no warp is kept back for loading: 8 warps, 2 on each of
//     the SM's 4 schedulers, up to 255 registers each);
//   - the pair's nstrips = ceil(S / 16) query strips of 16 rows are shared
//     among the warps through one sequence of (pair, strip) items per block,
//     so no warp idles at a pair's end and no strip stages K or V again.  A
//     block has min(8, nstrips) warps, so every warp has an item in every
//     pair: when it waits for pair i it has finished one of pair i - 2 (i - 1
//     with one stage), so the stage's barrier is in pair i's phase and its
//     parity bit cannot alias that earlier pair's;
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
//     rows in shared memory and leaves as 16-byte runs of its dh columns.
// q/k/v/out are addressed through element strides (batch, head, sequence).
//
// Head widths: each kernel is instantiated at DHP, the head width rounded up
// to 64-column atoms (64, 128, 192, 256).  A Q / K / V row is DHP / 64
// atoms, each one 128-byte swizzled row of one TMA box; the tensor map's
// inner dimension is the true width dh, so TMA fills the columns past it with
// zeros: zero columns of Q and K leave QK^T as it is, V's give output columns
// that are never stored, and no extra byte crosses device memory.  The maps'
// strides need dh % 8 == 0 (the wrapper pads any other width with zeros); the
// scale comes from the caller's true Dh, never from DHP.  Ranges (route()):
//   - dh <= 64, S <= 256: attn_fwd_kernel, above;
//   - dh <= 64, 256 < S <= REG_MAX_S (656; ViT-L/14 at 224 px: 257, at 336
//     px: 577): attn_reg_kernel, a 64-row query tile's scores for all keys
//     held in the registers of two consumer warpgroups;
//   - dh <= 64, S > REG_MAX_S: attn_long_kernel, the keys streamed twice;
//   - 64 < dh <= 128: attn_fwd_kernel at 128 up to 256 tokens, else
//     attn_long_kernel at 128 (ViT-H/14: dh = 80, S = 257);
//   - 128 < dh <= 256: attn_long_kernel at 192 or 256.
// S may be anything from 1 to MAX_S (int32 coordinates: 2^31 - 64); the
// element offsets are 64-bit.
// Bound at the L/14 gallery shape (B=128, H=16, S=257): 34.6 GFLOP against
// 269.5 MB of q/k/v/out, memory-bound (~80 us); at S=577 174.5 GFLOP
// against 605 MB (~181 us).  What binds the kernels there is the softmax:
// with Dh = 64 a score costs 256 flops of products and one exponential, and
// the H100 runs its exponentials (16 a clock an SM) about 250 times slower
// than its bf16 products, so one exponential a score costs as much as both
// products.  attn_reg_kernel's design:
//   - a persistent block an SM walks the (batch, head) pairs; a pair's K and
//     V (keys >= S zero filled, padded to 2 NW keys, NW a multiple of 8) are
//     staged once by TMA (64-row boxes of the same 4-d maps, so the model's
//     strided views need no copy) and stay while the pair's query tiles
//     pass, so each byte of K and V crosses device memory once; Q tiles come
//     through two stages.  A producer warpgroup's one thread issues every
//     load (full / empty mbarriers for K, V and each Q stage); the next
//     pair's K loads once the last tile's QK^T are done, under that tile's
//     softmax and PV, and its V once the PV are done;
//   - consumer warpgroup w holds the tile's f32 scores against keys
//     w NW .. w NW + NW - 1 (QK^T on wgmma, Q and K from shared memory, NW/2
//     accumulators a thread: 148 at S = 577), so each score takes ONE QK^T
//     and ONE exponential; each row's exact max and then its exact sum are
//     combined across the two warpgroups through shared memory (a named
//     barrier each), and P = 2^(s c - m c) * (1 / l) is cast to bf16 in the
//     registers it was computed in: the A operand of PV's wgmma, V (MN-major)
//     from shared memory.  Both hand their partial outputs (f32) to shared
//     memory; the producer warpgroup's three other warps add them and store
//     the tile's rows < S as 16-byte runs, while the consumers go on to the
//     next tile (two named barriers: the partials are in, the partials are
//     read);
//   - a tile whose last rows lie past S (S = 64 n + 1 leaves one row) still
//     runs its 64-row products (a wgmma's M), but a warp whose 16 rows all
//     lie past S skips their max, exponentials and sums: at S = 577 the
//     tenth tile costs its products and a quarter of a tile's softmax;
//   - causal: masked by index like keys >= S (no model path runs causal
//     past 256 tokens: the text tower's S is 77);
//   - REG_MAX_S: NW = 328 is the widest range that fits both the consumer
//     threads' 232 registers without spills (ptxas -v) and shared memory (K
//     and V at 704 rows, two Q stages, the two partials: 226 KB of 227); it
//     grows as DHP (4 KROWS + 768) bytes, so the kernel stays at DHP = 64;
//   - what it cannot do: a tile's phases run in turn (QK^T, max, the
//     exponentials, PV), since overlapping the next tile's QK^T with this
//     one's PV needs both tiles' registers (at S = 577 a thread's 148
//     scores, 74 of P and 32 of output: more than 232).
// attn_long_kernel's design:
//   - one block a (batch, head, 64-row query tile), the tiles of a pair
//     adjacent in the grid, so the pair's K and V, read by every tile, come
//     from L2 after the first; four consumer warps own a 16-row strip each
//     and one producer warp's lane 0 issues every TMA load;
//   - the tile's Q is staged once; K (and V) stream in blocks of 64 keys
//     (sequence coordinate kb * 64 of the same 4-d maps, rows >= S zero
//     filled) through a ring of stages (LongCfg: three at DHP 64 and 192,
//     two at 128, for two blocks an SM, and at 256, where three do not fit):
//     a `full` mbarrier a stage counts the bytes, an `empty` one the
//     consumer warps' releases; past DHP = 128 a strip reads its Q fragments
//     from the staged tile at each use, its registers held by the DHP / 8 x 4
//     accumulators;
//   - two passes over the keys: the first takes each row's f32 max and sum
//     (online), the second recomputes the scores and casts the normalised P
//     to bf16 for PV.  A one-pass online softmax casts P before the
//     normalisation, which moves its bf16 rounding off the TPU kernel's: a
//     difference of the size of P's own bf16 rounding against the plain
//     version, the order of chip_smoke.py's REL_TOL; the second QK^T costs
//     half as many products again;
//   - causal: a tile reads keys up to its last row only, and a strip skips
//     the blocks wholly above its diagonal (it still releases them).
#include "common.cuh"
#include "hopper.cuh"
#include "attention_wgmma.cuh"

using namespace port;
using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;      // attn_reg_kernel's head width (Dh <= 64 padded to it)
constexpr int ATOM = 64;    // head-dim columns of one 128-byte swizzled row: one TMA box wide
constexpr int MAX_DH = 256;
constexpr int WARPS = 8;  // at most; a block has min(WARPS, ceil(S / 16))
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_MAX = 232448;   // a block's shared memory
constexpr int SM_SMEM = 233472;    // an SM's, with 1 KB reserved a block

struct Strides {
  long long b, h, s;  // element strides; the head dim is contiguous
};

// KCH: rows staged in chunks of 16 (S <= 16 * KCH); DHP: the head width
// rounded up to 64-column atoms.  Two stages where two fit, else one.
template <int KCH, int DHP>
struct AttnCfg {
  static constexpr int ROWS = 16 * KCH;
  static constexpr int ATOMS = DHP / ATOM;
  static constexpr int TILE = ROWS * DHP * 2;  // bytes of one operand
  static constexpr int STAGE = 3 * TILE;       // q, k, v
  static constexpr int EXTRA = 4 * 8 + 1024;   // 2 mbarriers, 2 counters, alignment
  static constexpr int STAGES = 2 * STAGE + EXTRA <= SMEM_MAX ? 2 : 1;
  static constexpr int SMEM = STAGES * STAGE + EXTRA;
  static_assert(DHP % ATOM == 0 && SMEM <= SMEM_MAX, "shared memory");
};

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// the same for a tile of `rows` rows of DHP columns, held as DHP / 64 atoms
// of [rows][128 bytes] (one TMA box each): chunk c lies in atom c / 8
__device__ __forceinline__ uint32_t swz_a(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + swz(r, c & 7);
}

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
// pair p's q, k, v: DHP / 64 boxes an operand, columns past Dh zero filled
template <int KCH, int DHP>
__device__ __forceinline__ void fill_stage(unsigned char* dst, uint64_t* full,
                                           const CUtensorMap* map_q, const CUtensorMap* map_k,
                                           const CUtensorMap* map_v, int slots, int p, int H) {
  using C = AttnCfg<KCH, DHP>;
  mbar_arrive_expect_tx(full, C::STAGE);
  const int b = p / H, h = p - b * H;
  const CUtensorMap* maps[3] = {map_q, map_k, map_v};
  int c1, c2, c3;
#pragma unroll
  for (int op = 0; op < 3; ++op) {
    head_coords(slots >> (4 * op), h, b, c1, c2, c3);
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a)
      tma_load_4d(dst + op * C::TILE + a * C::ROWS * 128, maps[op], full, a * ATOM, c1, c2, c3);
  }
}

template <int KCH, int DHP>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, int slots, bf16* __restrict__ o,
                Strides os, int BH, int H, int S, int dh, float scale_log2, int causal) {
  using C = AttnCfg<KCH, DHP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + C::STAGES * C::STAGE);
  int* done = reinterpret_cast<int*>(full + 2);  // strips finished in each stage
  const int nstrips = (S + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    fence_barrier_init();
    // this block's first pairs into the stages
    for (int s = 0; s < C::STAGES && blockIdx.x + s * gridDim.x < BH; ++s)
      fill_stage<KCH, DHP>(stages + s * C::STAGE, &full[s], &map_q, &map_k, &map_v, slots,
                           blockIdx.x + s * gridDim.x, H);
  }
  __syncthreads();

  // item f = (pair i, strip j) of the block's sequence; pair i sits in stage
  // i % STAGES, in that stage's (i / STAGES)-th fill
  const int g = lane / 4, t = lane % 4;
  for (int f = warp;; f += warps) {
    const int i = f / nstrips, j = f - i * nstrips;
    const int p = blockIdx.x + i * gridDim.x;
    if (p >= BH) break;
    const int st = i % C::STAGES;
    mbar_wait(&full[st], (i / C::STAGES) & 1);
    unsigned char* sQ = stages + st * C::STAGE;
    const unsigned char* sK = sQ + C::TILE;
    const unsigned char* sV = sQ + 2 * C::TILE;
    const int r0 = j * 16;

    uint32_t qf[DHP / 16][4];
#pragma unroll
    for (int kc = 0; kc < DHP / 16; ++kc)
      ldmatrix_x4(qf[kc], sQ + swz_a(r0 + lane % 16, kc * 2 + lane / 16, C::ROWS));

    // scores: n8 block nb covers keys nb*8 .. nb*8+7
    float s[2 * KCH][4];
#pragma unroll
    for (int nb = 0; nb < 2 * KCH; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KCH; ++jj) {
#pragma unroll
      for (int kc = 0; kc < DHP / 16; ++kc) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + swz_a(jj * 16 + lane % 8 + (lane / 16) * 8, kc * 2 + (lane / 8) % 2,
                                   C::ROWS));
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
    // exp((s - m) * scale) = 2^(s c - m c), c = log2(e) * scale; masked keys give 0
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
    float acc[DHP / 8][4];
#pragma unroll
    for (int nb = 0; nb < DHP / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KCH; ++jj) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * jj][0] * inv0, s[2 * jj][1] * inv0);
      pa[1] = pack_bf16(s[2 * jj][2] * inv1, s[2 * jj][3] * inv1);
      pa[2] = pack_bf16(s[2 * jj + 1][0] * inv0, s[2 * jj + 1][1] * inv0);
      pa[3] = pack_bf16(s[2 * jj + 1][2] * inv1, s[2 * jj + 1][3] * inv1);
#pragma unroll
      for (int dp = 0; dp < DHP / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + swz_a(jj * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                         dp * 2 + lane / 16, C::ROWS));
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }

    // the strip's output through its own Q rows (no other warp reads them),
    // then out as 16-byte runs of the dh / 8 chunks a row stores
#pragma unroll
    for (int nb = 0; nb < DHP / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(sQ + swz_a(row0, nb, C::ROWS) + 4 * t) =
          pack_bf16(acc[nb][0], acc[nb][1]);
      *reinterpret_cast<uint32_t*>(sQ + swz_a(row1, nb, C::ROWS) + 4 * t) =
          pack_bf16(acc[nb][2], acc[nb][3]);
    }
    __syncwarp();
    const int b = p / H, h = p - b * H;
    bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a) {
        const int r = r0 + it * 4 + lane / 8, c = a * 8 + lane % 8;
        if (r < S && c < dh / 8)
          *reinterpret_cast<uint4*>(ob + r * os.s + c * 8) =
              *reinterpret_cast<const uint4*>(sQ + swz_a(r, c, C::ROWS));
      }
    }
    fence_proxy_async();  // these reads and writes come before the stage's next TMA fill
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[st], 1) == nstrips - 1) {  // the pair's last strip: refill
        done[st] = 0;
        __threadfence_block();
        const int pn = p + C::STAGES * gridDim.x;
        if (pn < BH)
          fill_stage<KCH, DHP>(sQ, &full[st], &map_q, &map_k, &map_v, slots, pn, H);
      }
    }
  }
}

// The TMA map of one operand, [B, H, S, dh] through element strides: dim 0 the
// head dim (dh columns; a box is 64 wide, zero filled past dh), then
// sequence, head and batch ordered by stride; the box is `rows` rows of one
// head (zero filled past S).  *slots gets the dims of head and batch.
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int H, int S, int dh, Strides st,
                     int rows, int* slots) {
  const long long ext[3] = {S, H, B}, str[3] = {st.s, st.h, st.b};
  int order[3] = {0, 1, 2};
  for (int a = 1; a < 3; ++a)
    for (int c = a; c > 0 && str[order[c]] < str[order[c - 1]]; --c) {
      const int tmp = order[c];
      order[c] = order[c - 1];
      order[c - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh)}, strides[3];
  cuuint32_t box[4] = {ATOM};
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

template <int KCH, int DHP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int S,
                   int dh, Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
                   int causal, cudaStream_t stream) {
  using C = AttnCfg<KCH, DHP>;
  CUtensorMap map_q, map_k, map_v;
  int sq = 0, sk = 0, sv = 0;
  cudaError_t e = head_map(&map_q, q, B, H, S, dh, qs, C::ROWS, &sq);
  if (e == cudaSuccess) e = head_map(&map_k, k, B, H, S, dh, ks, C::ROWS, &sk);
  if (e == cudaSuccess) e = head_map(&map_v, v, B, H, S, dh, vs, C::ROWS, &sv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_fwd_kernel<KCH, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  // no more warps than strips (the kernel's phase argument needs it)
  const int nstrips = (S + 15) / 16, threads = 32 * (nstrips < WARPS ? nstrips : WARPS);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_fwd_kernel<KCH, DHP>, threads,
                                                    C::SMEM);
  if (e != cudaSuccess) return e;
  const int BH = B * H, resident = sms * (per_sm > 0 ? per_sm : 1);
  attn_fwd_kernel<KCH, DHP><<<BH < resident ? BH : resident, threads, C::SMEM, stream>>>(
      map_q, map_k, map_v, sq | (sk << 4) | (sv << 8), o, os, BH, H, S, dh, scale_log2, causal);
  return cudaGetLastError();
}

// ---- the long path: a query tile a block, the keys streamed twice

constexpr int LONG_WARPS = 4;                         // consumer warps: 16 query rows each
constexpr int LONG_THREADS = (LONG_WARPS + 1) * 32;   // + one producer warp
constexpr int KB = 64;                                // keys a block
// the longest S: its tile and key-block coordinates (< S + 64) stay in int32
constexpr int MAX_S = 0x7fffffff - (KB - 1);

// the ring's depth and the blocks an SM holds, by padded head width: three
// blocks of three stages at 64; two of two at 128 (two of three do not fit);
// one of three at 192; one of two at 256 (three stages do not fit)
template <int DHP>
struct LongCfg {
  static constexpr int QROWS = 16 * LONG_WARPS;
  static constexpr int ATOMS = DHP / ATOM;
  static constexpr int QTILE = QROWS * DHP * 2;
  static constexpr int KTILE = KB * DHP * 2;
  static constexpr int STAGE = 2 * KTILE;  // k, v
  static constexpr int STAGES = DHP == 64 || DHP == 192 ? 3 : 2;
  static constexpr int MIN_BLOCKS = DHP == 64 ? 3 : DHP == 128 ? 2 : 1;
  static constexpr int SMEM = QTILE + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
  // Q fragments held in registers up to 128 columns; past that the
  // accumulators take the registers and Q is read again at each use
  static constexpr bool QHELD = DHP <= 128;
  static constexpr int QF = QHELD ? DHP / 16 : 1;
  static_assert(DHP % ATOM == 0 && SMEM <= SMEM_MAX && MIN_BLOCKS * (SMEM + 1024) <= SM_SMEM,
                "shared memory");
};

// TMA coordinates of rows s0.. of a head's box (the sequence lies in the
// dim that neither the head nor the batch takes)
__device__ __forceinline__ void seq_coords(int slots, int h, int b, int s0, int& c1, int& c2,
                                           int& c3) {
  head_coords(slots, h, b, c1, c2, c3);
  const int ss = 6 - (slots & 3) - ((slots >> 2) & 3);
  if (ss == 1) c1 += s0;
  if (ss == 2) c2 += s0;
  if (ss == 3) c3 += s0;
}

// a strip's scores against key block kb (KB keys in sK), masked by index; the
// strip's Q fragments from qf, or (DHP > 128) from its rows lr0.. of sQ
template <int DHP>
__device__ __forceinline__ void score_block(float (&s)[KB / 8][4],
                                            const uint32_t (&qf)[LongCfg<DHP>::QF][4],
                                            const unsigned char* sQ, int lr0,
                                            const unsigned char* sK, int kb, int S, int causal,
                                            int row0, int row1, int lane) {
  const int k0 = kb * KB, t = lane % 4;
#pragma unroll
  for (int nb = 0; nb < KB / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DHP / 16; ++kc) {
    uint32_t a[4];
    if constexpr (LongCfg<DHP>::QHELD) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
    } else {
      ldmatrix_x4(a, sQ + swz_a(lr0 + lane % 16, kc * 2 + lane / 16, LongCfg<DHP>::QROWS));
    }
#pragma unroll
    for (int jj = 0; jj < KB / 16; ++jj) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sK + swz_a(jj * 16 + lane % 8 + (lane / 16) * 8, kc * 2 + (lane / 8) % 2, KB));
      mma_bf16(s[2 * jj], a, kf[0], kf[1]);
      mma_bf16(s[2 * jj + 1], a, kf[2], kf[3]);
    }
  }
  if (causal || k0 + KB > S) {  // the same branch for the whole warp
#pragma unroll
    for (int nb = 0; nb < KB / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + 2 * t + (e & 1);
        if (col >= S || (causal && col > (e < 2 ? row0 : row1))) s[nb][e] = -1e30f;
      }
    }
  }
}

// The ring's items: 0 .. nkb - 1 bring K block i (pass 1), nkb .. 2 nkb - 1
// K and V block i - nkb (pass 2).  Pass 1 takes each row's max and sum
// (online: the sum rescaled when the max moves); pass 2 recomputes the
// scores and feeds P = 2^(s c - m c) / l, normalised in f32 and only then
// cast to bf16 as on the short path and in the TPU kernel, to PV.
template <int DHP>
__global__ void __launch_bounds__(LONG_THREADS, LongCfg<DHP>::MIN_BLOCKS)
attn_long_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, int slots, bf16* __restrict__ o,
                 Strides os, int H, int S, int dh, int qtiles, float scale_log2, int causal) {
  using C = LongCfg<DHP>;
  constexpr int NST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sQ + C::QTILE;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + NST * C::STAGE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NST;
  const int p = blockIdx.x / qtiles, q0 = (blockIdx.x - p * qtiles) * C::QROWS;
  const int b = p / H, h = p - b * H;
  const int rows = S - q0 < C::QROWS ? S - q0 : C::QROWS;
  const int active = (rows + 15) / 16;                       // consumer warps with rows
  const int nkb = ((causal ? q0 + rows : S) + KB - 1) / KB;  // key blocks the tile reads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int c1, c2, c3;
  if (warp == LONG_WARPS) {  // the producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, C::QTILE);
      seq_coords(slots, h, b, q0, c1, c2, c3);
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a)
        tma_load_4d(sQ + a * C::QROWS * 128, &map_q, qbar, a * ATOM, c1, c2, c3);
      for (int i = 0; i < 2 * nkb; ++i) {
        const int st = i % NST, kb = i < nkb ? i : i - nkb;
        if (i >= NST) mbar_wait(&empty[st], (i / NST - 1) & 1);
        unsigned char* dst = ring + st * C::STAGE;
        mbar_arrive_expect_tx(&full[st], i < nkb ? C::KTILE : C::STAGE);
        seq_coords(slots >> 4, h, b, kb * KB, c1, c2, c3);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a)
          tma_load_4d(dst + a * KB * 128, &map_k, &full[st], a * ATOM, c1, c2, c3);
        if (i >= nkb) {
          seq_coords(slots >> 8, h, b, kb * KB, c1, c2, c3);
#pragma unroll
          for (int a = 0; a < C::ATOMS; ++a)
            tma_load_4d(dst + C::KTILE + a * KB * 128, &map_v, &full[st], a * ATOM, c1, c2, c3);
        }
      }
    }
    return;
  }
  if (warp >= active) return;

  const int g = lane / 4, t = lane % 4;
  const int lr0 = warp * 16, row0 = q0 + lr0 + g, row1 = row0 + 8;
  // causal: the strip's last row is q0 + lr0 + 15; later blocks are all masked
  const int mine = causal ? (q0 + lr0 + 15) / KB + 1 : nkb;
  mbar_wait(qbar, 0);
  uint32_t qf[C::QF][4];
  if constexpr (C::QHELD) {
#pragma unroll
    for (int kc = 0; kc < DHP / 16; ++kc)
      ldmatrix_x4(qf[kc], sQ + swz_a(lr0 + lane % 16, kc * 2 + lane / 16, C::QROWS));
  }

  // pass 1: each row's max m and sum l (this lane's partial sums until the end)
  float m0 = -3.0e38f, m1 = -3.0e38f, l0 = 0.f, l1 = 0.f;
  float s[KB / 8][4];
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb % NST;
    mbar_wait(&full[st], (kb / NST) & 1);
    if (kb < mine) {
      score_block<DHP>(s, qf, sQ, lr0, ring + st * C::STAGE, kb, S, causal, row0, row1, lane);
      float n0 = m0, n1 = m1;
#pragma unroll
      for (int nb = 0; nb < KB / 8; ++nb) {
        n0 = fmaxf(n0, fmaxf(s[nb][0], s[nb][1]));
        n1 = fmaxf(n1, fmaxf(s[nb][2], s[nb][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, off));
        n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, off));
      }
      // block 0 holds key 0, which every row reads: the max is finite after it
      const float nc0 = n0 * scale_log2, nc1 = n1 * scale_log2;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < KB / 8; ++nb) {
        r0 += ex2(fmaf(s[nb][0], scale_log2, -nc0)) + ex2(fmaf(s[nb][1], scale_log2, -nc0));
        r1 += ex2(fmaf(s[nb][2], scale_log2, -nc1)) + ex2(fmaf(s[nb][3], scale_log2, -nc1));
      }
      l0 = fmaf(l0, ex2((m0 - n0) * scale_log2), r0);
      l1 = fmaf(l1, ex2((m1 - n1) * scale_log2), r1);
      m0 = n0;
      m1 = n1;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the stage's reads are done
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const float mc0 = m0 * scale_log2, mc1 = m1 * scale_log2;

  // pass 2: the normalised P, cast to bf16, against V
  float acc[DHP / 8][4];
#pragma unroll
  for (int nb = 0; nb < DHP / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    const int i = nkb + kb, st = i % NST;
    mbar_wait(&full[st], (i / NST) & 1);
    if (kb < mine) {
      const unsigned char* sK = ring + st * C::STAGE;
      score_block<DHP>(s, qf, sQ, lr0, sK, kb, S, causal, row0, row1, lane);
#pragma unroll
      for (int jj = 0; jj < KB / 16; ++jj) {
        uint32_t pa[4];
        pa[0] = pack_bf16(ex2(fmaf(s[2 * jj][0], scale_log2, -mc0)) * inv0,
                          ex2(fmaf(s[2 * jj][1], scale_log2, -mc0)) * inv0);
        pa[1] = pack_bf16(ex2(fmaf(s[2 * jj][2], scale_log2, -mc1)) * inv1,
                          ex2(fmaf(s[2 * jj][3], scale_log2, -mc1)) * inv1);
        pa[2] = pack_bf16(ex2(fmaf(s[2 * jj + 1][0], scale_log2, -mc0)) * inv0,
                          ex2(fmaf(s[2 * jj + 1][1], scale_log2, -mc0)) * inv0);
        pa[3] = pack_bf16(ex2(fmaf(s[2 * jj + 1][2], scale_log2, -mc1)) * inv1,
                          ex2(fmaf(s[2 * jj + 1][3], scale_log2, -mc1)) * inv1);
#pragma unroll
        for (int dp = 0; dp < DHP / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sK + C::KTILE + swz_a(jj * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                                      dp * 2 + lane / 16, KB));
          mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the strip's output through its own Q rows, then out as 16-byte runs
#pragma unroll
  for (int nb = 0; nb < DHP / 8; ++nb) {
    *reinterpret_cast<uint32_t*>(sQ + swz_a(lr0 + g, nb, C::QROWS) + 4 * t) =
        pack_bf16(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<uint32_t*>(sQ + swz_a(lr0 + g + 8, nb, C::QROWS) + 4 * t) =
        pack_bf16(acc[nb][2], acc[nb][3]);
  }
  __syncwarp();
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a) {
      const int lr = lr0 + it * 4 + lane / 8, c = a * 8 + lane % 8;
      if (q0 + lr < S && c < dh / 8)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(q0 + lr) * os.s + c * 8) =
            *reinterpret_cast<const uint4*>(sQ + swz_a(lr, c, C::QROWS));
    }
  }
}

template <int DHP>
cudaError_t launch_long(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H,
                        int S, int dh, Strides qs, Strides ks, Strides vs, Strides os,
                        float scale_log2, int causal, cudaStream_t stream) {
  using C = LongCfg<DHP>;
  const int qtiles = (S + C::QROWS - 1) / C::QROWS;
  const long long blocks = static_cast<long long>(B) * H * qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  int sq = 0, sk = 0, sv = 0;
  cudaError_t e = head_map(&map_q, q, B, H, S, dh, qs, C::QROWS, &sq);
  if (e == cudaSuccess) e = head_map(&map_k, k, B, H, S, dh, ks, KB, &sk);
  if (e == cudaSuccess) e = head_map(&map_v, v, B, H, S, dh, vs, KB, &sv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_long_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  attn_long_kernel<DHP><<<static_cast<unsigned>(blocks), LONG_THREADS, C::SMEM, stream>>>(
      map_q, map_k, map_v, sq | (sk << 4) | (sv << 8), o, os, H, S, dh, qtiles, scale_log2,
      causal);
  return cudaGetLastError();
}


// ---- 256 < S <= REG_MAX_S: a query tile's scores for all keys in registers

constexpr int WG = 128;                            // threads a warpgroup
constexpr int REG_CONS = 2;                        // consumer warpgroups: a key range each
constexpr int REG_THREADS = (REG_CONS + 1) * WG;   // + the producer warpgroup
constexpr int QT = 64;                             // query rows a tile: one wgmma M
constexpr int KBOX = 64;                           // K / V rows a TMA box
// the keys a consumer warpgroup holds, NW, by range of S: NW = REG_NW[i]
// serves 2 REG_NW[i - 1] < S <= 2 NW (from 257 for the first)
constexpr int REG_NW[] = {136, 216, 296, 328};
constexpr int REG_MAX_S = 2 * REG_NW[3];  // S_reg, 656
constexpr int reg_s_lo(int nw) {
  int lo = 257;
  for (int i = 0; i < 4 && REG_NW[i] < nw; ++i) lo = 2 * REG_NW[i] + 1;
  return lo;
}
constexpr int EPI_THREADS = WG - 32;                // the producer warpgroup's warps 1..3
// named barriers (0 is __syncthreads): the two consumer warpgroups' max and
// sum exchanges; their partial outputs ready for the epilogue warps, and read
constexpr int BAR_MAX = 1, BAR_SUM = 2, BAR_PART = 3, BAR_FREE = 4;
constexpr int PART_THREADS = REG_CONS * WG + EPI_THREADS;
static_assert(REG_CONS == 2, "the epilogue adds two partial outputs");

// NW keys a consumer warpgroup (a multiple of 8), QK^T in at most two wgmma
// of N0 + N1 = NW columns
template <int NW>
struct RegCfg {
  static constexpr int N0 = NW <= 256 ? NW : (NW / 16) * 8 + (NW % 16 ? 8 : 0);
  static constexpr int N1 = NW - N0;
  static constexpr int KEYS = REG_CONS * NW;
  // the first 8-key block of the last warpgroup that a key >= S can fall in,
  // for the shortest S this NW serves
  static constexpr int J_LO = reg_s_lo(NW) - NW - 7 <= 0 ? 0 : (reg_s_lo(NW) - NW) / 8;
  static constexpr int PSTEPS = (NW + 15) / 16;  // PV's k16 steps; the last may be half
  // rows staged: PV's half step past the last key reads 8 more (P = 0 there)
  static constexpr int KROWS = (KEYS + 8 + KBOX - 1) / KBOX * KBOX;
  static constexpr int KV = KROWS * DH * 2;
  static constexpr int QTILE = QT * DH * 2;
  static constexpr int OPART = QT * DH * 4;  // a warpgroup's partial output, f32
  static constexpr int RED = 2 * REG_CONS * QT * 4;
  static constexpr int SMEM = 2 * KV + 2 * QTILE + REG_CONS * OPART + RED + 8 * 8 + 1024;
  static_assert(NW % 8 == 0 && N0 % 8 == 0 && N1 % 8 == 0 && N0 <= 256 && N1 <= 256, "widths");
  static_assert(SMEM <= 232448, "shared memory");
};

// s[OFF ..] (+)= Q K^T for N keys: the wgmma of that width (FIRST: s[OFF ..] =)
template <int N, int OFF, bool FIRST, int R>
__device__ __forceinline__ void qk_mma(float (&s)[R], uint64_t da, uint64_t db) {
  constexpr int sd = FIRST ? 0 : 1;
  if constexpr (N == 136) wgmma_m64n136k16<OFF, FIRST>(s, da, db, sd);
  else if constexpr (N == 144) wgmma_m64n144k16<OFF, FIRST>(s, da, db, sd);
  else if constexpr (N == 152) wgmma_m64n152k16<OFF, FIRST>(s, da, db, sd);
  else if constexpr (N == 160) wgmma_m64n160k16<OFF, FIRST>(s, da, db, sd);
  else if constexpr (N == 168) wgmma_m64n168k16<OFF, FIRST>(s, da, db, sd);
  else if constexpr (N == 216) wgmma_m64n216k16<OFF, FIRST>(s, da, db, sd);
  else static_assert(N == 136, "no wgmma wrapper of this width (attention_wgmma.cuh)");
}

// the tile's scores against the warpgroup's NW keys (sK at its first key)
template <int NW, int R>
__device__ __forceinline__ void qk_tile(float (&s)[R], const unsigned char* sQ,
                                        const unsigned char* sK) {
  using C = RegCfg<NW>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint64_t da = desc_sw128(sQ + 32 * kk, 16, 1024);
    const uint64_t db0 = desc_sw128(sK + 32 * kk, 16, 1024);
    const uint64_t db1 = desc_sw128(sK + C::N0 * 128 + 32 * kk, 16, 1024);
    if (kk == 0) {
      qk_mma<C::N0, 0, true>(s, da, db0);
      if constexpr (C::N1 > 0) qk_mma<C::N1, C::N0 / 2, true>(s, da, db1);
    } else {
      qk_mma<C::N0, 0, false>(s, da, db0);
      if constexpr (C::N1 > 0) qk_mma<C::N1, C::N0 / 2, false>(s, da, db1);
    }
  }
}

// One block an SM walks the (batch, head) pairs; a pair's K and V are staged
// once and stay while its query tiles pass.  Warpgroup w in 0..1 holds the
// tile's f32 scores against keys w NW .. w NW + NW - 1 in registers; the
// exact row max and sum are combined across the two through shared memory,
// so each score takes one QK^T and one exponential, and P = 2^(s c - m c) / l
// is normalised in f32 before its bf16 cast, as on the short path and in the
// TPU kernel.  Warpgroup 2 is the producer: one thread issues every TMA load,
// and its other three warps sum the two partial outputs of each tile and store
// it, off the consumers' path.
template <int NW>
__global__ void __launch_bounds__(REG_THREADS, 1)
attn_reg_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, int slots, bf16* __restrict__ o,
                Strides os, int BH, int H, int S, int dh, float scale_log2, int causal) {
  using C = RegCfg<NW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + C::KV;
  unsigned char* sQ = sV + C::KV;  // two stages
  // each consumer warpgroup's partial output [QT][DH] f32, row r's 8-column
  // chunk c at chunk c ^ (r % 8)
  float* sPart = reinterpret_cast<float*>(sQ + 2 * C::QTILE);
  float* red_max = sPart + REG_CONS * QT * DH;  // [REG_CONS][QT]
  float* red_sum = red_max + REG_CONS * QT;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(red_sum + REG_CONS * QT);
  uint64_t* kempty = kfull + 1;
  uint64_t* vfull = kfull + 2;
  uint64_t* vempty = kfull + 3;
  uint64_t* qfull = kfull + 4;   // two
  uint64_t* qempty = kfull + 6;  // two
  const int qtiles = (S + QT - 1) / QT, nkb = (S + KBOX - 1) / KBOX;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  if (threadIdx.x == 0) {
    mbar_init(kfull, 1);
    mbar_init(vfull, 1);
    mbar_init(kempty, REG_CONS);
    mbar_init(vempty, REG_CONS);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], REG_CONS);
    }
    fence_barrier_init();
  }
  // the staged rows no TMA box writes are zeros: PV multiplies them by P = 0
  {
    const int from = nkb * KBOX * DH * 2 / 16, to = C::KV / 16;
    for (int i = from + threadIdx.x; i < to; i += blockDim.x) {
      reinterpret_cast<uint4*>(sK)[i] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(sV)[i] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();  // before wgmma reads them
  }
  __syncthreads();

  if (wg == REG_CONS) {  // the producer
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int c1, c2, c3, qi = 0, pi = 0;
      for (int p = blockIdx.x; p < BH; p += gridDim.x, ++pi) {
        const int b = p / H, h = p - b * H;
        if (pi > 0) mbar_wait(kempty, (pi - 1) & 1);  // the last pair's QK^T are done
        mbar_arrive_expect_tx(kfull, nkb * KBOX * DH * 2);
        for (int kb = 0; kb < nkb; ++kb) {
          seq_coords(slots >> 4, h, b, kb * KBOX, c1, c2, c3);
          tma_load_4d(sK + kb * KBOX * DH * 2, &map_k, kfull, 0, c1, c2, c3);
        }
        for (int t = 0; t < qtiles; ++t, ++qi) {
          const int st = qi & 1;
          if (qi >= 2) mbar_wait(&qempty[st], ((qi >> 1) - 1) & 1);
          mbar_arrive_expect_tx(&qfull[st], C::QTILE);
          seq_coords(slots, h, b, t * QT, c1, c2, c3);
          tma_load_4d(sQ + st * C::QTILE, &map_q, &qfull[st], 0, c1, c2, c3);
          if (t == 0) {  // V after the pair's first Q: its QK^T and softmax come first
            if (pi > 0) mbar_wait(vempty, (pi - 1) & 1);
            mbar_arrive_expect_tx(vfull, nkb * KBOX * DH * 2);
            for (int kb = 0; kb < nkb; ++kb) {
              seq_coords(slots >> 8, h, b, kb * KBOX, c1, c2, c3);
              tma_load_4d(sV + kb * KBOX * DH * 2, &map_v, vfull, 0, c1, c2, c3);
            }
          }
        }
      }
    } else if (tid >= 32) {  // warps 1..3: each item's epilogue, the two partials added
      const int et = tid - 32;
      for (int p = blockIdx.x; p < BH; p += gridDim.x) {
        const int b = p / H, h = p - b * H;
        const bool last_pair = p + gridDim.x >= BH;
        for (int t = 0; t < qtiles; ++t) {
          named_barrier(BAR_PART, PART_THREADS);  // the item's partials are in sPart
          const int q0 = t * QT;
          bf16* ob = o + b * os.b + h * os.h + q0 * os.s;
          for (int i = et; i < QT * DH / 8; i += EPI_THREADS) {
            const int r = i / (DH / 8), c = i % (DH / 8);
            const int off = r * DH + ((c ^ (r & 7)) * 8);
            const float4* a = reinterpret_cast<const float4*>(sPart + off);
            const float4* a2 = reinterpret_cast<const float4*>(sPart + QT * DH + off);
            const float4 x0 = a[0], x1 = a[1], y0 = a2[0], y1 = a2[1];
            uint4 out;
            out.x = pack_bf16(x0.x + y0.x, x0.y + y0.y);
            out.y = pack_bf16(x0.z + y0.z, x0.w + y0.w);
            out.z = pack_bf16(x1.x + y1.x, x1.y + y1.y);
            out.w = pack_bf16(x1.z + y1.z, x1.w + y1.w);
            if (q0 + r < S && c < dh / 8) *reinterpret_cast<uint4*>(ob + r * os.s + c * 8) = out;
          }
          if (!(last_pair && t == qtiles - 1))
            named_barrier_arrive(BAR_FREE, PART_THREADS);  // sPart may be written again
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int key0 = wg * NW;        // this warpgroup's keys: key0 .. key0 + NW - 1
  const int lr0 = warp * 16 + g;   // this thread's rows of the tile: lr0, lr0 + 8
  float* part = sPart + wg * QT * DH;  // this warpgroup's partial output
  float s[NW / 2];
  float acc[DH / 2];
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) acc[e] = 0.f;
  int qi = 0, pi = 0;  // the block's Q tiles and pairs so far
  for (int p = blockIdx.x; p < BH; p += gridDim.x, ++pi) {
    const unsigned char* kbuf = sK + key0 * 128;  // this warpgroup's keys
    const unsigned char* vbuf = sV + key0 * 128;
    for (int tile = 0; tile < qtiles; ++tile, ++qi) {
      const int q0 = tile * QT, st = qi & 1;
      const int row0 = q0 + lr0, row1 = row0 + 8;
      const bool live = q0 + warp * 16 < S;  // the warp holds a row < S (warp-uniform)
      mbar_wait(&qfull[st], (qi >> 1) & 1);
      if (tile == 0) mbar_wait(kfull, pi & 1);

      // S = Q K^T against this warpgroup's keys
      wgmma_fence();
      qk_tile<NW>(s, sQ + st * C::QTILE, kbuf);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (tid == 0) {
        mbar_arrive(&qempty[st]);
        if (tile == qtiles - 1) mbar_arrive(kempty);
      }

      // mask by index: causal, every element; else the keys >= S, which only
      // the last warpgroup's blocks from J_LO on can hold in this NW's range of S
      if (causal) {
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) {
          const int col = key0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (col >= S || col > ((i & 2) ? row1 : row0)) s[i] = -1e30f;
        }
      } else if (wg == REG_CONS - 1) {
#pragma unroll
        for (int i = 4 * C::J_LO; i < NW / 2; ++i) {
          const int col = key0 + 8 * (i / 4) + 2 * t + (i & 1);
          s[i] = col < S ? s[i] : -1e30f;
        }
      }
      // each row's max: this thread's, its quad's, then the other warpgroup's
      float m0 = -3.0e38f, m1 = -3.0e38f;
      if (live) {
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          m0 = fmaxf(m0, fmaxf(s[4 * i], s[4 * i + 1]));
          m1 = fmaxf(m1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      if (t == 0) {
        red_max[wg * QT + lr0] = m0;
        red_max[wg * QT + lr0 + 8] = m1;
      }
      named_barrier(BAR_MAX, REG_CONS * WG);
#pragma unroll
      for (int w = 0; w < REG_CONS; ++w) {
        m0 = fmaxf(m0, red_max[w * QT + lr0]);
        m1 = fmaxf(m1, red_max[w * QT + lr0 + 8]);
      }

      // one exponential a score: 2^(s c - m c), c = log2(e) / sqrt(Dh); each row's sum
      const float mc0 = m0 * scale_log2, mc1 = m1 * scale_log2;
      float l0 = 0.f, l1 = 0.f;
      if (live) {
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          s[4 * i] = ex2(fmaf(s[4 * i], scale_log2, -mc0));
          s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], scale_log2, -mc0));
          s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], scale_log2, -mc1));
          s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], scale_log2, -mc1));
          l0 += s[4 * i] + s[4 * i + 1];
          l1 += s[4 * i + 2] + s[4 * i + 3];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      if (t == 0) {
        red_sum[wg * QT + lr0] = l0;
        red_sum[wg * QT + lr0 + 8] = l1;
      }
      named_barrier(BAR_SUM, REG_CONS * WG);
      l0 = l1 = 0.f;
#pragma unroll
      for (int w = 0; w < REG_CONS; ++w) {
        l0 += red_sum[w * QT + lr0];
        l1 += red_sum[w * QT + lr0 + 8];
      }
      // a warp with no row < S feeds P = 0 (its rows are not stored)
      const float inv0 = live ? 1.f / l0 : 0.f, inv1 = live ? 1.f / l1 : 0.f;

      // P normalised in f32, then cast to bf16: PV's A operand, from registers
      uint32_t pa[C::PSTEPS][4];
#pragma unroll
      for (int j = 0; j < C::PSTEPS; ++j) {
        pa[j][0] = pack_bf16(s[8 * j] * inv0, s[8 * j + 1] * inv0);
        pa[j][1] = pack_bf16(s[8 * j + 2] * inv1, s[8 * j + 3] * inv1);
        if (8 * j + 4 < NW / 2) {
          pa[j][2] = pack_bf16(s[8 * j + 4] * inv0, s[8 * j + 5] * inv0);
          pa[j][3] = pack_bf16(s[8 * j + 6] * inv1, s[8 * j + 7] * inv1);
        } else {  // the half step past the last key
          pa[j][2] = pa[j][3] = 0u;
        }
      }
      if (tile == 0) mbar_wait(vfull, pi & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < C::PSTEPS; ++j)
        wgmma_m64n64k16_rs(acc, pa[j], desc_sw128(vbuf + 16 * j * 128, 8192, 1024), j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < C::PSTEPS; ++j)  // read by the wgmma until the wait
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[j][e]) :: "memory");
      if (tid == 0 && tile == qtiles - 1) mbar_arrive(vempty);

      // hand the partial output to the producer warpgroup's epilogue warps,
      // once they have read the last item's
      if (qi > 0) named_barrier(BAR_FREE, PART_THREADS);
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb) {
        const int off = lr0 * DH + ((nb ^ g) * 8) + 2 * t;  // lr0 % 8 == g
        *reinterpret_cast<float2*>(part + off) = make_float2(acc[4 * nb], acc[4 * nb + 1]);
        *reinterpret_cast<float2*>(part + off + 8 * DH) =
            make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
      }
      named_barrier_arrive(BAR_PART, PART_THREADS);
    }
  }
}

template <int NW>
cudaError_t launch_reg(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int S,
                       int dh, Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
                       int causal, cudaStream_t stream) {
  using C = RegCfg<NW>;
  CUtensorMap map_q, map_k, map_v;
  int sq = 0, sk = 0, sv = 0;
  cudaError_t e = head_map(&map_q, q, B, H, S, dh, qs, QT, &sq);
  if (e == cudaSuccess) e = head_map(&map_k, k, B, H, S, dh, ks, KBOX, &sk);
  if (e == cudaSuccess) e = head_map(&map_v, v, B, H, S, dh, vs, KBOX, &sv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_reg_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const int BH = B * H;
  attn_reg_kernel<NW><<<BH < sms ? BH : sms, REG_THREADS, C::SMEM, stream>>>(
      map_q, map_k, map_v, sq | (sk << 4) | (sv << 8), o, os, BH, H, S, dh, scale_log2, causal);
  return cudaGetLastError();
}

// Which kernel serves (dh, S), and at which padded head width *dhp:
//   dh <= 64:        S <= 256 attn_fwd_kernel, S <= REG_MAX_S attn_reg_kernel,
//                    longer attn_long_kernel, all at 64;
//   64 < dh <= 128:  S <= 256 attn_fwd_kernel at 128 (a strip's 128 scores, 32
//                    registers of Q fragments, 64 of output: under 255), longer
//                    attn_long_kernel at 128 (attn_reg_kernel's shared memory
//                    grows as DHP (4 KROWS + 768) bytes: 256 KB at 128 and
//                    257 tokens, past the 227 KB a block has);
//   128 < dh <= 256: attn_long_kernel at 192 or 256 at every S.
// 0 when nothing serves them (dh outside 1..256, S outside 1..MAX_S).
enum Route { NONE = 0, FWD = 1, REG = 2, LONG = 3 };
Route route(int dh, int S, int* dhp) {
  if (dh < 1 || dh > MAX_DH || S < 1 || S > MAX_S) return NONE;
  *dhp = (dh + ATOM - 1) / ATOM * ATOM;
  if (*dhp == 64) return S <= 256 ? FWD : S <= REG_MAX_S ? REG : LONG;
  return *dhp == 128 && S <= 256 ? FWD : LONG;
}

template <int DHP>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int S,
                       int dh, Strides qs, Strides ks, Strides vs, Strides os, float sl,
                       int causal, cudaStream_t st) {
  if (S <= 64) return launch<4, DHP>(q, k, v, o, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  if (S <= 128) return launch<8, DHP>(q, k, v, o, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  if (S <= 208) return launch<13, DHP>(q, k, v, o, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  return launch<16, DHP>(q, k, v, o, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
}

}  // namespace

// route(dh, S) as 1000 * kernel (1 attn_fwd_kernel, 2 attn_reg_kernel, 3
// attn_long_kernel) + the padded head width, 0 if no kernel serves it: what
// ops/fused_attention.py::attention_route mirrors
extern "C" int attn_route(int dh, int S) {
  int dhp = 0;
  const Route r = route(dh, S, &dhp);
  return r == NONE ? 0 : 1000 * r + dhp;
}

// q, k, v, o: [B, H, S, dh] bf16 addressed through element strides (batch,
// head, sequence); the head dim must be contiguous, dh % 8 == 0 and rows
// 16-byte aligned.  The logits are scaled by `scale` (the caller's 1 /
// sqrt(Dh) of the true head width, which the padded width must not replace).
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int S, int dh, long long qb, long long qh,
                        long long qsq, long long kb, long long kh, long long ksq,
                        long long vb, long long vh, long long vsq, long long ob,
                        long long oh, long long osq, float scale, int causal, void* stream) {
  const Strides qs{qb, qh, qsq}, ks{kb, kh, ksq}, vs{vb, vh, vsq}, os{ob, oh, osq};
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  bf16* o_ = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dhp = 0;
  const Route r = route(dh, S, &dhp);
  if (r == NONE || B <= 0 || H <= 0 || dh % 8 != 0 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float sl = 1.4426950408889634f * scale;  // log2(e) * scale
  cudaError_t e;
  if (r == FWD)
    e = dhp == 64 ? launch_fwd<64>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st)
                  : launch_fwd<128>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else if (r == REG && S <= 2 * REG_NW[0])
    e = launch_reg<REG_NW[0]>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else if (r == REG && S <= 2 * REG_NW[1])
    e = launch_reg<REG_NW[1]>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else if (r == REG && S <= 2 * REG_NW[2])
    e = launch_reg<REG_NW[2]>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else if (r == REG)
    e = launch_reg<REG_NW[3]>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else if (dhp == 64)
    e = launch_long<64>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else if (dhp == 128)
    e = launch_long<128>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else if (dhp == 192)
    e = launch_long<192>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  else
    e = launch_long<256>(q_, k_, v_, o_, B, H, S, dh, qs, ks, vs, os, sl, causal, st);
  return static_cast<int>(e);
}
