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
// to the row tile, and the grid runs in parallel:
//   - block tiles of BM x 128 (BM = block_rows: 64, 128 or 256, a template
//     parameter, the counterpart of the TPU probe's row-block sweep), 8 warps
//     in 2 x 4 of (BM / 2) x 32, mma.sync with a 4-stage cp.async pipeline;
//   - blockIdx.x walks the 128-column tiles fastest, so the blocks in flight
//     share one row tile of x and the weight (4.7 MB in bf16, 2.4 MB in int8)
//     stays in the 50 MB L2;
//   - bf16: m16n8k16, A fragments by ldmatrix from row-major x, B by
//     ldmatrix .trans from the row-major [K, N] weight (the LN-free core of
//     fused_block.cu), epilogue a bf16 store;
//   - int8: m16n8k32 s8, the weight taken K-major ([K, N] view of [N, K]
//     storage): there is no 8-bit ldmatrix .trans on sm_90, and the plain
//     ldmatrix .b16 of a K-major 8 x 16-byte tile hands each lane the four k
//     bytes of its fragment (fused_block_int8.cu); epilogue an s32 store.
// Rows >= M are zero-filled on load and never stored, so a ragged M is
// computed in full (the TPU kernel's grid of m // block_rows steps leaves the
// last m % block_rows rows unwritten).  K must be a multiple of the k-tile
// (32 bf16 values, 64 int8 values) and N of 128: the wrapper checks.
// The int32 output's 311 MB bound the int8 mode; the simple epilogue (8-byte
// stores of accumulator pairs) is what a faster version would change first.
#include "common.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 128, THREADS = 256, STAGES = 4;
constexpr int BK16 = 32, LDA16 = BK16 + 8, LDB16 = BN + 8;  // bf16: 80 B / 272 B rows
constexpr int BK8 = 64, LD8 = BK8 + 16;                     // int8: 80 B rows

template <int BM>
struct Tiles {
  static constexpr int MI = BM / 32;  // 16-row fragments per warp: warp rows = BM / 2
  static constexpr int BF16_BYTES = STAGES * (BM * LDA16 + BK16 * LDB16) * 2;
  static constexpr int INT8_BYTES = STAGES * (BM + BN) * LD8;
  static constexpr int MIN_BLOCKS = BM >= 256 ? 1 : 2;  // 128 accumulators a thread at 256
};

template <int BM>
__global__ void __launch_bounds__(THREADS, Tiles<BM>::MIN_BLOCKS)
    matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ out, int M, int N, int K) {
  constexpr int MI = Tiles<BM>::MI;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * BM * LDA16;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int bn = blockIdx.x * BN, bm = blockIdx.y * BM;
  const int nk = K / BK16;

  // start the copies of k-tile kt into pipeline stage st
  auto load_stage = [&](int kt, int st) {
    if (kt < nk) {
      const int k0 = kt * BK16;
#pragma unroll
      for (int i = 0; i < BM * BK16 / 8 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BK16 / 8), col = (c % (BK16 / 8)) * 8;
        const bool in = bm + r < M;
        cp_async16(sA + (st * BM + r) * LDA16 + col,
                   in ? x + static_cast<long long>(bm + r) * K + k0 + col : x, in);
      }
#pragma unroll
      for (int i = 0; i < BK16 * BN / 8 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        cp_async16(sB + (st * BK16 + r) * LDB16 + col,
                   w + static_cast<long long>(k0 + r) * N + bn + col, true);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s, s);

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    cp_async_wait<STAGES - 2>();  // k-tile kt has landed
    __syncthreads();              // everyone's copies visible; stage kt-1 free
    load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    const bf16* a_tile = sA + st * BM * LDA16;
    const bf16* b_tile = sB + st * BK16 * LDB16;
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t bfr[2][4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4_trans(bfr[jp], b_tile + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDB16 +
                                       wn * 32 + jp * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, a_tile + (wm * (BM / 2) + i * 16 + lane % 16) * LDA16 + kk +
                            (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af, bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: each thread owns pairs of neighbouring columns
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = bm + wm * (BM / 2) + i * 16 + g + hr * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = bn + wn * 32 + j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N + col) =
            pack_bf16(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
      }
    }
  }
}

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

template <int BM, bool INT8>
cudaError_t run(const void* x, const void* w, void* out, int M, int N, int K,
                cudaStream_t stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaError_t e;
  if constexpr (INT8) {
    constexpr int bytes = Tiles<BM>::INT8_BYTES;
    e = cudaFuncSetAttribute(matmul_int8_kernel<BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    matmul_int8_kernel<BM><<<grid, THREADS, bytes, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<int*>(out),
        M, N, K);
  } else {
    constexpr int bytes = Tiles<BM>::BF16_BYTES;
    e = cudaFuncSetAttribute(matmul_bf16_kernel<BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    matmul_bf16_kernel<BM><<<grid, THREADS, bytes, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), M,
        N, K);
  }
  return cudaGetLastError();
}

template <bool INT8>
int dispatch(const void* x, const void* w, void* out, int M, int N, int K, int block_rows,
             void* stream) {
  if (M <= 0 || N <= 0 || N % BN != 0 || K <= 0 || K % (INT8 ? BK8 : BK16) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 64: return static_cast<int>(run<64, INT8>(x, w, out, M, N, K, st));
    case 128: return static_cast<int>(run<128, INT8>(x, w, out, M, N, K, st));
    case 256: return static_cast<int>(run<256, INT8>(x, w, out, M, N, K, st));
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [M, N] bf16 = x [M, K] bf16 @ w [K, N] bf16 (row-major), f32 accumulators.
extern "C" int matmul_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                           int block_rows, void* stream) {
  return dispatch<false>(x, w, out, M, N, K, block_rows, stream);
}

// out [M, N] int32 = x [M, K] int8 @ w, with w [K, N] int8 stored K-major
// ([N, K] contiguous), exact s32 accumulators.
extern "C" int matmul_int8(const void* x, const void* w, void* out, int M, int N, int K,
                           int block_rows, void* stream) {
  return dispatch<true>(x, w, out, M, N, K, block_rows, stream);
}
