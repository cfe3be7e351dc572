// The tiled matmul of the roofline microbenchmark: out = x [M, K] @ w [K, N] on
// the tensor cores, in the two modes of the TPU probe:
//   bf16 x bf16 -> f32 accumulators -> bf16 out;
//   int8 x int8 -> exact s32 accumulators -> int32 out.
//
// Replaces: tools/perf_microbench.py::_pallas_matmul (pallas_call at :110),
// the plain tiled Pallas matmul behind the probes pallas_bf16, pallas_int8
// and pallas_sweep.
//
// Bound on an H100 at the probe's shape M = 25,344, K = 768, N = 3072 (119.6
// GFLOP; 989 TFLOP/s dense bf16, 1,979 TOP/s dense int8, 3.35 TB/s):
//   bf16: 0.1209 ms of operations against 199.4 MB (0.0595 ms): operations.
//   int8: 0.0604 ms of operations against 333.3 MB, 311 MB of it the int32
//         output (0.0995 ms): bytes.
// The TPU kernel keeps the whole [K, N] weight and one block_rows x K row
// tile in VMEM and makes one MXU product per grid step.  A Hopper block has
// 227 KB of shared memory, so the weight streams through it in k-tiles next
// to the row tile.
//
// bf16 (operations-bound): the tensor cores reach their rate only through
// wgmma fed from shared memory, so the kernel is Hopper's warp-specialised
// GEMM (hopper.cuh):
//   - a persistent grid, one block per SM, walks the output tiles in order,
//     column tiles fastest, so the blocks in flight share a few row panels of
//     x and the weight (4.7 MB) stays in the 50 MB L2;
//   - one producer thread keeps a ring of STAGES k-tiles (64 k values) full
//     with TMA: x as [BM][64] and w as TN / 64 boxes of [64 k][64 n], both
//     128-byte swizzled; full / empty mbarriers hand the stages over, so the
//     next tile's loads run during this tile's epilogue;
//   - consumer warpgroups issue wgmma m64nNk16 with both operands read from
//     shared memory by descriptor: x K-major, w MN-major through the
//     instruction's transpose flag (no transposed copy of w); one wgmma group
//     stays in flight while the previous stage is released;
//   - block_rows (the TPU probe's row-block sweep, a template parameter)
//     picks the tile: 64 -> 1 consumer warpgroup of 64 x 256; 128 -> 2 of
//     64 x 256; 256 -> 2 of 128 x 128 (two m64n128 products per k step);
//     setmaxnreg gives the two-consumer tiles' 128 accumulators a thread
//     the producer's registers;
//   - the epilogue writes each consumer's accumulators as bf16 into its own
//     swizzled output tile in shared memory, and one thread stores it by TMA
//     while the warpgroup goes on to the next tile's products (the ring has
//     3 stages at block_rows 128 and 256, 4 at 64, to leave room for it);
//   - TMA zero-fills rows >= M and a k-tail past K (K % 64 != 0) on load and
//     skips rows >= M and columns >= N on store, so a ragged M is computed in
//     full (the TPU kernel's grid of m // block_rows steps leaves the last
//     m % block_rows rows unwritten).
// int8 (bytes-bound by its int32 output): block tiles of BM x 128, 8 warps in
//   2 x 4 of (BM / 2) x 32, mma.sync m16n8k32 s8 with a 4-stage cp.async
//   pipeline, the weight taken K-major ([K, N] view of [N, K] storage): there
//   is no 8-bit ldmatrix .trans on sm_90, and the plain ldmatrix .b16 of a
//   K-major 8 x 16-byte tile hands each lane the four k bytes of its fragment
//   (fused_block_int8.cu); epilogue an s32 store.  Rows >= M are zero-filled
//   on load and never stored.  The simple epilogue (8-byte stores of
//   accumulator pairs) is what a faster version would change first.
// The wrapper takes K a multiple of 32 (bf16) or 64 (int8) and N of 128.
#include "common.cuh"
#include "hopper.cuh"

using namespace port;
using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

// ---- bf16: wgmma + TMA

constexpr int BK = 64;   // k values a stage: one 128-byte swizzled row of x
constexpr int WG = 128;  // threads of a warpgroup

template <int BM>
struct Bf16Tile;  // TN columns, CONS consumer warpgroups of MI x 64 rows
template <>
struct Bf16Tile<64> { static constexpr int TN = 256, CONS = 1, MI = 1, STAGES = 4; };
template <>
struct Bf16Tile<128> { static constexpr int TN = 256, CONS = 2, MI = 1, STAGES = 3; };
template <>
struct Bf16Tile<256> { static constexpr int TN = 128, CONS = 2, MI = 2, STAGES = 3; };

template <int BM>
struct Bf16Cfg : Bf16Tile<BM> {
  static constexpr int THREADS = (Bf16Tile<BM>::CONS + 1) * WG;  // + the producer warpgroup
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * Bf16Tile<BM>::TN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // a consumer warpgroup's output tile, bf16, as TN / 64 swizzled [MI x 64][64] boxes
  static constexpr int C_BYTES = Bf16Tile<BM>::MI * 64 * Bf16Tile<BM>::TN * 2;
  // the ring, the output tiles, 2 x STAGES mbarriers, slack to align to 1024 bytes
  static constexpr int SMEM =
      Bf16Tile<BM>::STAGES * (STAGE_BYTES + 16) + Bf16Tile<BM>::CONS * C_BYTES + 1024;
};

// d (+)= a * b for one m64 piece, all TN columns, w MN-major
template <int TN>
__device__ __forceinline__ void mma_k16(float (&d)[TN / 2], uint64_t da, uint64_t db,
                                        int scale_d) {
  if constexpr (TN == 256)
    wgmma_m64n256k16<1>(d, da, db, scale_d);
  else
    wgmma_m64n128k16<1>(d, da, db, scale_d);
}

template <int BM>
__global__ void __launch_bounds__(Bf16Cfg<BM>::THREADS, 1)
    matmul_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_out, int M, int N, int K) {
  using C = Bf16Cfg<BM>;
  constexpr int TN = C::TN, CONS = C::CONS, MI = C::MI, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sB = sA + STAGES * C::A_BYTES;
  unsigned char* sC = sB + STAGES * C::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + CONS * C::C_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = (K + BK - 1) / BK;
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
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * TN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&full[st], C::STAGE_BYTES);
          tma_load_2d(sA + st * C::A_BYTES, &map_x, &full[st], kt * BK, m0);
#pragma unroll
          for (int j = 0; j < TN / 64; ++j)
            tma_load_2d(sB + st * C::B_BYTES + j * 64 * 128, &map_w, &full[st], n0 + j * 64,
                        kt * BK);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows wg * MI * 64 .. of the tile, all TN columns
    if constexpr (CONS > 1) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    float acc[MI][TN / 2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[mi][i] = 0.f;
    int st = 0, ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * TN;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[st], ph);
        const unsigned char* a = sA + st * C::A_BYTES + wg * MI * 64 * 128;
        const unsigned char* b = sB + st * C::B_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = desc_sw128(b + kk * 16 * 128, 64 * 128, 1024);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            mma_k16<TN>(acc[mi], desc_sw128(a + mi * 64 * 128 + kk * 32, 16, 1024), db,
                        kt > 0 || kk > 0);
        }
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

      // epilogue: the accumulators as bf16 into this warpgroup's swizzled
      // output boxes (conflict-free: row r's chunk j sits at j ^ (r % 8)),
      // then one thread stores them by TMA, which skips rows >= M and
      // columns >= N and runs on while the next tile's products start
      unsigned char* c = sC + wg * C::C_BYTES;
      if (tid == 0) bulk_wait_read<0>();  // the previous tile's store has read c
      named_barrier(1 + wg, WG);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = mi * 64 + warp * 16 + lane / 4 + hr * 8;
#pragma unroll
          for (int j = 0; j < TN / 8; ++j)
            *reinterpret_cast<uint32_t*>(c + (j / 8) * MI * 64 * 128 + r * 128 +
                                         (((j % 8) ^ (r % 8)) << 4) + 4 * (lane % 4)) =
                pack_bf16(acc[mi][4 * j + 2 * hr], acc[mi][4 * j + 2 * hr + 1]);
        }
      }
      fence_proxy_async();  // the writes above before the TMA engine reads them
      named_barrier(1 + wg, WG);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < TN / 64; ++bx)
          tma_store_2d(&map_out, c + bx * MI * 64 * 128, n0 + bx * 64, m0 + wg * MI * 64);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();  // the last stores are done before the block exits
  }
}

// ---- int8: mma.sync m16n8k32, cp.async

constexpr int BN = 128, THREADS = 256, STAGES = 4;
constexpr int BK8 = 64, LD8 = BK8 + 16;  // int8: 80 B rows

template <int BM>
struct Tiles {
  static constexpr int MI = BM / 32;  // 16-row fragments per warp: warp rows = BM / 2
  static constexpr int INT8_BYTES = STAGES * (BM + BN) * LD8;
  static constexpr int MIN_BLOCKS = BM >= 256 ? 1 : 2;  // 128 accumulators a thread at 256
};

template <int BM>
__global__ void __launch_bounds__(THREADS, Tiles<BM>::MIN_BLOCKS)
    matmul_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       int* __restrict__ out, int M, int N, int K) {
  constexpr int MI = Tiles<BM>::MI;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = sA + STAGES * BM * LD8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int bn = blockIdx.x * BN, bm = blockIdx.y * BM;
  const int nk = K / BK8;

  // start the copies of k-tile kt into pipeline stage st: rows x 4 16-byte
  // chunks of each operand (w K-major: row n holds column n's k bytes)
  auto load_stage = [&](int kt, int st) {
    if (kt < nk) {
      const int k0 = kt * BK8;
#pragma unroll
      for (int i = 0; i < BM * BK8 / 16 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BK8 / 16), col = (c % (BK8 / 16)) * 16;
        const bool in = bm + r < M;
        cp_async16(sA + (st * BM + r) * LD8 + col,
                   in ? x + static_cast<long long>(bm + r) * K + k0 + col : x, in);
      }
#pragma unroll
      for (int i = 0; i < BN * BK8 / 16 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BK8 / 16), col = (c % (BK8 / 16)) * 16;
        cp_async16(sB + (st * BN + r) * LD8 + col,
                   w + static_cast<long long>(bn + r) * K + k0 + col, true);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s, s);

  int acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    const int8_t* a_tile = sA + st * BM * LD8;
    const int8_t* b_tile = sB + st * BN * LD8;
#pragma unroll
    for (int kk = 0; kk < BK8; kk += 32) {
      uint32_t bfr[2][4];
      // W: matrices (n 0-7: bytes 0-15, 16-31 | n 8-15: ...) -> b0, b1 of two n8 blocks
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4(bfr[jp], b_tile + (wn * 32 + jp * 16 + (lane / 16) * 8 + lane % 8) * LD8 +
                                 kk + ((lane / 8) % 2) * 16);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) -> a0..a3
        uint32_t af[4];
        ldmatrix_x4(af, a_tile + (wm * (BM / 2) + i * 16 + lane % 16) * LD8 + kk +
                            (lane / 16) * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af, bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = bm + wm * (BM / 2) + i * 16 + g + hr * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = bn + wn * 32 + j * 8 + 2 * t;
        *reinterpret_cast<int2*>(out + static_cast<long long>(row) * N + col) =
            make_int2(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
      }
    }
  }
}

template <int BM>
cudaError_t run_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                     cudaStream_t stream) {
  using C = Bf16Cfg<BM>;
  CUtensorMap map_x, map_w, map_out;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t x_box[2] = {BK, BM};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t w_box[2] = {64, BK};
  cudaError_t e = make_map_bf16(&map_x, x, 2, x_dims, x_strides, x_box);
  if (e != cudaSuccess) return e;
  e = make_map_bf16(&map_w, w, 2, w_dims, w_strides, w_box);
  if (e != cudaSuccess) return e;
  const cuuint64_t out_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint32_t out_box[2] = {64, Bf16Tile<BM>::MI * 64};
  e = make_map_bf16(&map_out, out, 2, out_dims, w_strides, out_box);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(matmul_bf16_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + BM - 1) / BM) * ((N + C::TN - 1) / C::TN);
  matmul_bf16_kernel<BM><<<tiles < sms ? tiles : sms, C::THREADS, C::SMEM, stream>>>(
      map_x, map_w, map_out, M, N, K);
  return cudaGetLastError();
}

template <int BM>
cudaError_t run_int8(const void* x, const void* w, void* out, int M, int N, int K,
                     cudaStream_t stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  constexpr int bytes = Tiles<BM>::INT8_BYTES;
  cudaError_t e = cudaFuncSetAttribute(matmul_int8_kernel<BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  matmul_int8_kernel<BM><<<grid, THREADS, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<int*>(out), M,
      N, K);
  return cudaGetLastError();
}

template <int BM>
cudaError_t run(bool int8, const void* x, const void* w, void* out, int M, int N, int K,
                cudaStream_t stream) {
  return int8 ? run_int8<BM>(x, w, out, M, N, K, stream) : run_bf16<BM>(x, w, out, M, N, K, stream);
}

int dispatch(bool int8, const void* x, const void* w, void* out, int M, int N, int K,
             int block_rows, void* stream) {
  if (M <= 0 || N <= 0 || N % BN != 0 || K <= 0 || K % (int8 ? BK8 : 32) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 64: return static_cast<int>(run<64>(int8, x, w, out, M, N, K, st));
    case 128: return static_cast<int>(run<128>(int8, x, w, out, M, N, K, st));
    case 256: return static_cast<int>(run<256>(int8, x, w, out, M, N, K, st));
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [M, N] bf16 = x [M, K] bf16 @ w [K, N] bf16 (row-major), f32 accumulators.
extern "C" int matmul_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                           int block_rows, void* stream) {
  return dispatch(false, x, w, out, M, N, K, block_rows, stream);
}

// out [M, N] int32 = x [M, K] int8 @ w, with w [K, N] int8 stored K-major
// ([N, K] contiguous), exact s32 accumulators.
extern "C" int matmul_int8(const void* x, const void* w, void* out, int M, int N, int K,
                           int block_rows, void* stream) {
  return dispatch(true, x, w, out, M, N, K, block_rows, stream);
}
