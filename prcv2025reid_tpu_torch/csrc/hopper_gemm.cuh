// The port's Hopper GEMM core: a persistent, warp-specialised wgmma + TMA
// mainloop with an epilogue parameter, shared by every GEMM of the port's
// Hopper kernels.
//
//   out[g] = epilogue(A[g] [M, K] @ B[g] [K, N])   for g < G
//
// Every operand is a 3-d TMA tensor map over (columns, rows, group): a tile
// past a group's last row is zero-filled on load and clipped on store, so a
// ragged M never reads or writes the next group's rows, and a k-tail past K
// is zero-filled in both operands.
//
//   - A persistent grid, one block per SM, walks the output tiles in order,
//     column tiles fastest, so the blocks in flight share a few row panels
//     of A and the weight stays in the 50 MB L2.
//   - One producer thread keeps a ring of STAGES k-tiles full by TMA; each
//     stage holds 128 bytes of k per row of A (128-byte swizzle) and the
//     matching B tile.  full / empty mbarriers hand the stages over, so the
//     next tile's loads run during this tile's epilogue.
//   - CONS consumer warpgroups, each MI x 64 rows and all TN columns of the
//     tile, issue wgmma from shared memory by descriptor, keeping one wgmma
//     group in flight while the previous stage is released; setmaxnreg moves
//     the producer's registers to them.
//   - The epilogue stages the consumer's results in its own swizzled tile in
//     shared memory and one thread stores them by TMA, which runs on while
//     the warpgroup starts the next tile's products.
//
// The operand policy (Bf16Op, S8Op) says how a stage's B tile is loaded and
// which wgmma consumes it.  The epilogue policy is an output layout with a
// value function (Act) applied to each accumulator pair:
//   Bf16Out<NONE>       the tiled matmul, bf16 (matmul.cu)
//   Bf16Out<BIAS>       the fused MLP's fc2 (fused_mlp.cu) and the bf16 QKV
//                       GEMM (fused_block.cu::ln_qkv)
//   Bf16Out<BIAS_GELU>  fc1 of the fused MLP and of fused_out_mlp (fused_mlp.cu,
//                       fused_block.cu)
//   Bf16Out<RES_X2>     fused_out_mlp's fc2: + b2 and the f32 residual x2
//   Bf16Out<DQ_RES_X2>  the int8 fc2 of the int8 MLP tail (fused_block_int8.cu)
//   Bf16Out<DQ_BIAS>    the int8 QKV GEMM (fused_block_int8.cu::ln_qkv_int8)
//   S32Out              the tiled matmul, int8 -> int32 (matmul.cu)
//   F32Out<RES_X>       the bf16 out-projection x2 = x + (acc + bo) in f32
//                       (fused_block.cu::out_proj, used by fused_out_mlp and
//                       the mixed int8 plan)
//   F32Out<DQ_GELU>     the int8 fc1 of the int8 MLP tail: f32 h and each
//                       row's max |h| for its quantization
//   F32Out<DQ_RES_X>    the int8 out-projection x2 = (x + dq(acc)) + bo in f32
//                       (fused_block_int8.cu::out_mlp_int8)
// Residuals are read straight from device memory in the epilogue; scales and
// biases once per row or column pair.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace hgemm {

using namespace hopper;

constexpr int WG = 128;     // threads of a warpgroup
constexpr int ROW = 128;    // bytes of k a stage holds per row of A (and of a K-major B)
constexpr int BOX = 8192;   // one [64 rows][128 bytes] swizzled box

// ---- operand policies

// bf16: A K-major; B the row-major [K, N] weight, read MN-major through the
// transpose flag from TN / 64 boxes of [64 k][64 n] (LBO = 8192 bytes to the
// next 64-wide box); wgmma k16, 4 steps a stage.
struct Bf16Op {
  typedef float Acc;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int ESIZE = 2, BK = ROW / ESIZE;  // 64 k values a stage

  template <int TN>
  static constexpr int b_bytes() { return BK * TN * 2; }
  // the B map's box: {64 n, 64 k}
  static constexpr int B_BOX0 = 64, B_BOX1 = BK;

  template <int TN>
  __device__ static void load_b(unsigned char* sB, const CUtensorMap* map, uint64_t* bar,
                                int n0, int k0, int g) {
#pragma unroll
    for (int j = 0; j < TN / 64; ++j) tma_load_3d(sB + j * BOX, map, bar, n0 + j * 64, k0, g);
  }

  template <int TN>
  __device__ static void wgmma(float (&d)[TN / 2], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (TN == 256)
      wgmma_m64n256k16<1>(d, da, db, scale_d);
    else if constexpr (TN == 192)
      wgmma_m64n192k16<1>(d, da, db, scale_d);
    else
      wgmma_m64n128k16<1>(d, da, db, scale_d);
  }

  template <int MI, int TN>
  __device__ static void mma(float (&acc)[MI][TN / 2], const unsigned char* a,
                             const unsigned char* b, bool first) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(b + kk * 16 * 128, BOX, 1024);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        wgmma<TN>(acc[mi], desc_sw128(a + mi * BOX + kk * 32, 16, 1024), db, !first || kk > 0);
    }
  }
};

// int8: both operands K-major (8-bit wgmma has no transpose flag): the
// weight stored [N, K], one [TN n][128 k] box a stage; wgmma k32, 4 steps.
struct S8Op {
  typedef int Acc;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int ESIZE = 1, BK = ROW;  // 128 k values a stage

  template <int TN>
  static constexpr int b_bytes() { return TN * ROW; }
  // the B map's box: {128 k, TN n}, over the [N, K] storage
  template <int TN>
  __device__ static void load_b(unsigned char* sB, const CUtensorMap* map, uint64_t* bar,
                                int n0, int k0, int g) {
    tma_load_3d(sB, map, bar, k0, n0, g);
  }

  template <int MI, int TN>
  __device__ static void mma(int (&acc)[MI][TN / 2], const unsigned char* a,
                             const unsigned char* b, bool first) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(b + kk * 32, 16, 1024);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint64_t da = desc_sw128(a + mi * BOX + kk * 32, 16, 1024);
        if constexpr (TN == 256)
          wgmma_m64n256k32_s8(acc[mi], da, db, !first || kk > 0);
        else if constexpr (TN == 192)
          wgmma_m64n192k32_s8(acc[mi], da, db, !first || kk > 0);
        else
          wgmma_m64n128k32_s8(acc[mi], da, db, !first || kk > 0);
      }
    }
  }
};

// ---- epilogue policies.  A consumer warpgroup holds rows m0 .. m0 + MI * 64
// of the tile and columns n0 .. n0 + TN; thread (warp, lane) holds, of each
// 64-row piece, rows 16 warp + lane / 4 (+ 8) and column pairs 8 j + 2 (lane % 4).
// An epilogue is an output layout (Bf16Out: 2-byte, S32Out / F32Out: 4-byte)
// with a value function (Act) applied to each accumulator pair before it is
// staged; dq(acc) = (acc * s_row) * s_col dequantizes an s32 accumulator.

enum Act {
  NONE = 0,       // acc                                      bf16 out
  BIAS = 1,       // acc + b                                  bf16 out
  BIAS_GELU = 2,  // GELU(acc + b)                            bf16 out
  RES_X = 3,      // x + (acc + b), x bf16 [G, M, N]           f32 out
  RES_X2 = 4,     // x2 + (acc + b), x2 f32 [G, M, N]          bf16 out
  DQ_GELU = 5,    // GELU(dq(acc) + b), and each row's max     f32 out
  DQ_RES_X2 = 6,  // (x2 + dq(acc)) + b, x2 f32 [G, M, N]      bf16 out
  IDENT = 7,      // acc                                      int32 out
  DQ_BIAS = 8,    // dq(acc) + b                              bf16 out
  DQ_RES_X = 9,   // (x + dq(acc)) + b, x bf16 [G, M, N]       f32 out
};

struct Params {
  int M, N, K, G;
  const float* bias;      // [G, N] f32 (every Act but NONE and IDENT)
  const void* res;        // [G, M, N] residual: bf16 (RES_X, DQ_RES_X) or f32 (RES_X2, DQ_RES_X2)
  const float* s_row;     // [G, M] row scales of A (DQ_*)
  const float* s_col;     // [G, N] column scales of B (DQ_*)
  unsigned int* row_max;  // [G, M] bits of each row's max |out| (DQ_GELU), zeroed by the caller
};

__host__ __device__ constexpr bool dequantizes(int act) {
  return act == DQ_GELU || act == DQ_RES_X2 || act == DQ_BIAS || act == DQ_RES_X;
}

// the f32 roundings of the TPU kernels' order, kept apart (no FMA contraction)
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

// what a column pair reads once per tile: its bias and column scales (0 past N)
struct ColPair {
  float2 b, s;
};

template <int ACT>
__device__ __forceinline__ ColPair col_pair(const Params& p, int g, int col) {
  ColPair c{make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  if constexpr (ACT != NONE && ACT != IDENT) {
    if (col < p.N) {  // N % 8 == 0: col + 1 < N when col < N
      const long long off = static_cast<long long>(g) * p.N + col;
      c.b = __ldg(reinterpret_cast<const float2*>(p.bias + off));
      if constexpr (dequantizes(ACT)) c.s = __ldg(reinterpret_cast<const float2*>(p.s_col + off));
    }
  }
  return c;
}

// a row's scale of A (DQ_*; 0 past the group's last row, which is not stored)
template <int ACT>
__device__ __forceinline__ float row_scale_of(const Params& p, int g, int row) {
  if constexpr (dequantizes(ACT))
    return row < p.M ? __ldg(p.s_row + static_cast<long long>(g) * p.M + row) : 0.f;
  return 0.f;
}

// the output pair (row, col .. col + 1) from its accumulators (ACT != IDENT)
template <int ACT, class Acc>
__device__ __forceinline__ float2 value(Acc a0, Acc a1, const ColPair& c, float s_row,
                                        const Params& p, int g, int row, int col) {
  if constexpr (ACT == NONE) {
    return make_float2(a0, a1);
  } else if constexpr (ACT == BIAS) {
    return make_float2(a0 + c.b.x, a1 + c.b.y);
  } else if constexpr (ACT == BIAS_GELU) {
    return make_float2(port::gelu_as(a0 + c.b.x), port::gelu_as(a1 + c.b.y));
  } else if constexpr (ACT == DQ_BIAS) {
    return make_float2(__fadd_rn(dequant(a0, s_row, c.s.x), c.b.x),
                       __fadd_rn(dequant(a1, s_row, c.s.y), c.b.y));
  } else if constexpr (ACT == DQ_GELU) {
    return make_float2(port::gelu_as(__fadd_rn(dequant(a0, s_row, c.s.x), c.b.x)),
                       port::gelu_as(__fadd_rn(dequant(a1, s_row, c.s.y), c.b.y)));
  } else {  // a residual, read straight from device memory (a quad reads 16 or 32 bytes)
    float2 r = make_float2(0.f, 0.f);
    if (row < p.M && col < p.N) {
      const long long off = (static_cast<long long>(g) * p.M + row) * p.N + col;
      if constexpr (ACT == RES_X || ACT == DQ_RES_X)
        r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p.res) + off));
      else
        r = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p.res) + off));
    }
    if constexpr (ACT == DQ_RES_X2 || ACT == DQ_RES_X)
      return make_float2(__fadd_rn(__fadd_rn(r.x, dequant(a0, s_row, c.s.x)), c.b.x),
                         __fadd_rn(__fadd_rn(r.y, dequant(a1, s_row, c.s.y)), c.b.y));
    else  // RES_X, RES_X2
      return make_float2(r.x + (a0 + c.b.x), r.y + (a1 + c.b.y));
  }
}

// bf16 out: bf16(value) into TN / 64 swizzled boxes of [MI x 64 rows][64
// columns] (row r's chunk c at c ^ (r % 8): conflict-free), then one TMA
// store per box.  The stores of the previous tile must have read the boxes
// first.
template <int ACT>
struct Bf16Out {
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int ESIZE = 2, BOX0 = 64;  // columns of a store box

  template <int MI, int TN>
  static constexpr int bytes() { return MI * 64 * TN * 2; }
  template <int MI>
  static constexpr int box_rows() { return MI * 64; }

  template <int MI, int TN, class Acc>
  __device__ static void store(Acc (&acc)[MI][TN / 2], unsigned char* c, const CUtensorMap* map,
                               int m0, int n0, int g, const Params& p, int, int wg, int tid) {
    const int warp = tid / 32, lane = tid % 32;
    float s_row[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        s_row[mi][hr] = row_scale_of<ACT>(p, g, m0 + mi * 64 + warp * 16 + lane / 4 + hr * 8);
    if (tid == 0) bulk_wait_read<0>();
    named_barrier(1 + wg, WG);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const ColPair cp = col_pair<ACT>(p, g, col);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = mi * 64 + warp * 16 + lane / 4 + hr * 8;
          const float2 v = value<ACT>(acc[mi][4 * j + 2 * hr], acc[mi][4 * j + 2 * hr + 1], cp,
                                      s_row[mi][hr], p, g, m0 + r, col);
          *reinterpret_cast<uint32_t*>(c + (j / 8) * MI * BOX + r * 128 +
                                       (((j % 8) ^ (r % 8)) << 4) + 4 * (lane % 4)) =
              port::pack_bf16(v.x, v.y);
        }
      }
    }
    fence_proxy_async();  // the writes above before the TMA engine reads them
    named_barrier(1 + wg, WG);
    if (tid == 0) {
#pragma unroll
      for (int bx = 0; bx < TN / 64; ++bx) tma_store_3d(map, c + bx * MI * BOX, n0 + bx * 64, m0, g);
      bulk_commit();
    }
  }
};

// 4-byte out (int32 for IDENT, else f32 value): a consumer's tile is MI x 64
// rows by TN columns of 4 bytes (64 KB at 64 x 256), more than shared memory
// spares, so it leaves in sub-tiles of [64 rows][64 columns] through two 16 KB
// buffers, used in turn across the block's tiles: each sub-tile waits until
// the store of the sub-tile two back has read its buffer, is written as two
// swizzled [64][32] boxes (8-byte pairs, two wavefronts a warp: the least for
// 256 bytes) and stored by TMA while the next is written.  DQ_GELU also
// takes each row's max |value| over the tile's columns < N: a quad shuffle,
// then one atomicMax on the float's bits per row and warp.
template <int ACT>
struct Word32Out {
  static constexpr CUtensorMapDataType TYPE =
      ACT == IDENT ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int ESIZE = 4, BOX0 = 32;  // columns of a store box (128 bytes)

  template <int MI, int TN>
  static constexpr int bytes() { return 2 * 2 * BOX; }
  template <int MI>
  static constexpr int box_rows() { return 64; }

  // `it`: the tiles this block stored before, so the buffers alternate across tiles
  template <int MI, int TN, class Acc>
  __device__ static void store(Acc (&acc)[MI][TN / 2], unsigned char* c, const CUtensorMap* map,
                               int m0, int n0, int g, const Params& p, int it, int wg, int tid) {
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      float s_row[2], row_max[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        s_row[hr] = row_scale_of<ACT>(p, g, m0 + mi * 64 + warp * 16 + lane / 4 + hr * 8);
#pragma unroll
      for (int s = 0; s < TN / 64; ++s) {
        unsigned char* buf = c + ((it * MI * (TN / 64) + mi * (TN / 64) + s) % 2) * 2 * BOX;
        if (tid == 0) bulk_wait_read<1>();  // the store two sub-tiles back has read buf
        named_barrier(1 + wg, WG);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = s * 8 + jj, col = n0 + 8 * j + 2 * t;
          const ColPair cp = col_pair<ACT>(p, g, col);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = warp * 16 + lane / 4 + hr * 8;
            int2 bits;
            if constexpr (ACT == IDENT) {
              bits = make_int2(acc[mi][4 * j + 2 * hr], acc[mi][4 * j + 2 * hr + 1]);
            } else {
              const float2 v = value<ACT>(acc[mi][4 * j + 2 * hr], acc[mi][4 * j + 2 * hr + 1],
                                          cp, s_row[hr], p, g, m0 + mi * 64 + r, col);
              if constexpr (ACT == DQ_GELU)
                if (col < p.N) row_max[hr] = fmaxf(row_max[hr], fmaxf(fabsf(v.x), fabsf(v.y)));
              bits = make_int2(__float_as_int(v.x), __float_as_int(v.y));
            }
            *reinterpret_cast<int2*>(buf + (jj / 4) * BOX + r * 128 +
                                     (((2 * (jj % 4) + t / 2) ^ (r % 8)) << 4) + 8 * (t % 2)) = bits;
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, WG);
        if (tid == 0) {
          tma_store_3d(map, buf, n0 + s * 64, m0 + mi * 64, g);
          tma_store_3d(map, buf + BOX, n0 + s * 64 + 32, m0 + mi * 64, g);
          bulk_commit();
        }
      }
      if constexpr (ACT == DQ_GELU) {  // the quad's four lanes share each row
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float m = row_max[hr];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const int row = m0 + mi * 64 + warp * 16 + lane / 4 + hr * 8;
          if (t == 0 && row < p.M)
            atomicMax(p.row_max + static_cast<long long>(g) * p.M + row, __float_as_uint(m));
        }
      }
    }
  }
};

using S32Out = Word32Out<IDENT>;
template <int ACT>
using F32Out = Word32Out<ACT>;

// ---- the kernel

template <class Op, class Out, int BM_, int TN_, int CONS_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, TN = TN_, CONS = CONS_, STAGES = STAGES_;
  static constexpr int MI = BM / (CONS * 64);  // 64-row pieces a consumer
  static constexpr int THREADS = (CONS + 1) * WG;  // + the producer warpgroup
  static constexpr int A_BYTES = BM * ROW, B_BYTES = Op::template b_bytes<TN>();
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_BYTES = Out::template bytes<MI, TN>();
  // the ring, the output tiles, 2 x STAGES mbarriers, slack to align to 1024 bytes
  static constexpr int SMEM = STAGES * (STAGE_BYTES + 16) + CONS * C_BYTES + 1024;
  static_assert(BM == CONS * MI * 64 && TN % 64 == 0, "tile shape");
  static_assert(SMEM <= 232448, "shared memory");
};

template <class Op, class Out, class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, const Params p) {
  constexpr int BM = C::BM, TN = C::TN, CONS = C::CONS, MI = C::MI, STAGES = C::STAGES;
  typedef typename Op::Acc Acc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sB = sA + STAGES * C::A_BYTES;
  unsigned char* sC = sB + STAGES * C::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + CONS * C::C_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (p.N + TN - 1) / TN;
  const int tiles_mn = ((p.M + BM - 1) / BM) * tiles_n;
  const int tiles = p.G * tiles_mn;
  const int nk = (p.K + Op::BK - 1) / Op::BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONS) {  // the producer warpgroup: one thread issues every load
    if constexpr (CONS > 1) setmaxnreg_dec<40>();
    if (threadIdx.x == CONS * WG) {
      int st = 0, ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int g = tile / tiles_mn, mn = tile % tiles_mn;
        const int m0 = (mn / tiles_n) * BM, n0 = (mn % tiles_n) * TN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&full[st], C::STAGE_BYTES);
          tma_load_3d(sA + st * C::A_BYTES, &map_a, &full[st], kt * Op::BK, m0, g);
          Op::template load_b<TN>(sB + st * C::B_BYTES, &map_b, &full[st], n0, kt * Op::BK, g);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows wg * MI * 64 .. of the tile, all TN columns
    if constexpr (CONS > 1) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % WG;
    Acc acc[MI][TN / 2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[mi][i] = 0;
    int st = 0, ph = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int g = tile / tiles_mn, mn = tile % tiles_mn;
      const int m0 = (mn / tiles_n) * BM, n0 = (mn % tiles_n) * TN;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[st], ph);
        wgmma_fence();
        Op::template mma<MI, TN>(acc, sA + st * C::A_BYTES + wg * MI * BOX, sB + st * C::B_BYTES,
                                 kt == 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-tile's products are done: free its stage
        if (kt > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = st;
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
      Out::template store<MI, TN>(acc, sC + wg * C::C_BYTES, &map_c, m0 + wg * MI * 64, n0, g, p,
                                  it, wg, tid);
    }
    if (threadIdx.x % WG == 0) bulk_wait<0>();  // the last stores are done before the block exits
  }
}

// ---- host

// a 3-d map over a row-major [G][rows][cols] tensor of `esize`-byte elements
inline cudaError_t map_3d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
                          int G, int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * esize,
                                 static_cast<cuuint64_t>(rows) * cols * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  return make_map(map, type, base, 3, dims, strides, box);
}

// out[g] = epilogue(a[g] [M, K] @ b[g]) for g < G: a row-major; b row-major
// [K, N] for Bf16Op, [N, K] (K-major) for S8Op; out row-major [M, N].
template <class Op, class Out, int BM, int TN, int CONS, int STAGES>
cudaError_t gemm(const void* a, const void* b, void* out, const Params& p, cudaStream_t stream) {
  using C = Cfg<Op, Out, BM, TN, CONS, STAGES>;
  CUtensorMap map_a, map_b, map_c;
  cudaError_t e = map_3d(&map_a, Op::TYPE, Op::ESIZE, a, p.G, p.M, p.K, Op::BK, BM);
  if (e != cudaSuccess) return e;
  if constexpr (Op::ESIZE == 2)
    e = map_3d(&map_b, Op::TYPE, 2, b, p.G, p.K, p.N, Op::B_BOX0, Op::B_BOX1);
  else
    e = map_3d(&map_b, Op::TYPE, 1, b, p.G, p.N, p.K, Op::BK, TN);
  if (e != cudaSuccess) return e;
  e = map_3d(&map_c, Out::TYPE, Out::ESIZE, out, p.G, p.M, p.N, Out::BOX0,
             Out::template box_rows<C::MI>());
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gemm_kernel<Op, Out, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  const long long tiles =
      static_cast<long long>(p.G) * ((p.M + BM - 1) / BM) * ((p.N + TN - 1) / TN);
  gemm_kernel<Op, Out, C><<<static_cast<int>(tiles < sms ? tiles : sms), C::THREADS, C::SMEM,
                            stream>>>(map_a, map_b, map_c, p);
  return cudaGetLastError();
}

}  // namespace hgemm
