// Fused multi-head attention forward for the ViT trunk: softmax(QK^T/sqrt(Dh))V
// with the [S, S] scores kept on chip.
//
// Replaces: prcv2025reid_tpu/ops/pallas_attention.py::_attn_kernel_batched_heads
// (pallas_mha kernel_version=2) and ::_attn_kernel (kernel_version=1).  The TPU
// kernels differ only in their grid split, so one Hopper kernel serves both.
//
// Bound on an H100 (vision shape B=128, H=12, S=197, Dh=64): 15.3 GFLOP of
// products against 155 MB of q/k/v/out, so it is memory-bound (~46 us at
// 3.35 TB/s).  Design: one block of 4 warps per (batch, head, 64-row query
// tile).  The head's K and V (S x 64 bf16) and the Q tile are staged in shared
// memory once, with all copies in flight together (cp.async); each warp keeps
// its 16 rows of f32 scores for ALL keys in registers (S <= 256), so scores,
// max-subtracted softmax and P never touch device memory.  QK^T and PV run on the tensor cores (mma.sync m16n8k16,
// f32 accumulation); P is normalised in f32 and cast to bf16 before PV, as the
// TPU kernel does.  Keys >= S are masked by index to -1e9 (no padded copies of
// the inputs); causal masking is optional.  q/k/v/out are read and written
// through element strides, so the model passes views of its fused QKV
// projection without transposing copies.
#include "common.cuh"

using namespace port;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;        // head dim the kernel is written for
constexpr int QT = 64;        // query rows per block (4 warps x 16)
constexpr int LDS = DH + 8;   // smem row stride: 144 B keeps ldmatrix conflict-free

struct Strides {
  long long b, h, s;  // element strides; the head dim is contiguous
};

template <int KCH>  // keys staged in chunks of 16: S <= 16 * KCH
__global__ void __launch_bounds__(128, 3)  // 3 blocks (12 warps) per SM: <= 170 registers
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                Strides qs, Strides ks, Strides vs, Strides os, float scale,
                int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + KCH * 16 * LDS;
  bf16* sQ = sV + KCH * 16 * LDS;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  // stage Q, K, V with every copy in flight at once (zero rows past S, so
  // masked keys multiply zeros)
  for (int i = tid; i < QT * (DH / 8); i += blockDim.x) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const bool in = q0 + r < S;
    cp_async16(sQ + r * LDS + c, in ? qb + (q0 + r) * qs.s + c : qb, in);
  }
  for (int i = tid; i < KCH * 16 * (DH / 8); i += blockDim.x) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const bool in = r < S;
    cp_async16(sK + r * LDS + c, in ? kb + r * ks.s + c : kb, in);
    cp_async16(sV + r * LDS + c, in ? vb + r * vs.s + c : vb, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wrow = warp * 16;  // this warp's first row inside the tile
  if (q0 + wrow >= S) return;  // nothing of this warp's rows is kept

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldmatrix_x4(qf[kc], sQ + (wrow + lane % 16) * LDS + kc * 16 + (lane / 16) * 8);

  // scores: n8 block nb covers keys nb*8 .. nb*8+7
  float s[2 * KCH][4];
#pragma unroll
  for (int nb = 0; nb < 2 * KCH; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int j = 0; j < KCH; ++j) {
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sK + (j * 16 + lane % 8 + (lane / 16) * 8) * LDS + kc * 16 +
                          ((lane / 8) % 2) * 8);
      mma_bf16(s[2 * j], qf[kc], kf[0], kf[1]);
      mma_bf16(s[2 * j + 1], qf[kc], kf[2], kf[3]);
    }
  }

  // scale, mask, f32 softmax over each row (a row lives on the 4 lanes of a quad)
  const int row0 = q0 + wrow + g, row1 = row0 + 8;
  float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
  for (int nb = 0; nb < 2 * KCH; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nb * 8 + 2 * t + (e & 1);
      const int row = (e < 2) ? row0 : row1;
      float val = s[nb][e] * scale;
      if (col >= S || (causal && col > row)) val = -1e9f;
      s[nb][e] = val;
    }
    m0 = fmaxf(m0, fmaxf(s[nb][0], s[nb][1]));
    m1 = fmaxf(m1, fmaxf(s[nb][2], s[nb][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < 2 * KCH; ++nb) {
    s[nb][0] = expf(s[nb][0] - m0);
    s[nb][1] = expf(s[nb][1] - m0);
    s[nb][2] = expf(s[nb][2] - m1);
    s[nb][3] = expf(s[nb][3] - m1);
    l0 += s[nb][0] + s[nb][1];
    l1 += s[nb][2] + s[nb][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // PV: the score accumulators of key chunk j are exactly the A fragment
  float acc[DH / 8][4];
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int j = 0; j < KCH; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * j][0] / l0, s[2 * j][1] / l0);
    pa[1] = pack_bf16(s[2 * j][2] / l1, s[2 * j][3] / l1);
    pa[2] = pack_bf16(s[2 * j + 1][0] / l0, s[2 * j + 1][1] / l0);
    pa[3] = pack_bf16(s[2 * j + 1][2] / l1, s[2 * j + 1][3] / l1);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sV + (j * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDS +
                                dp * 16 + (lane / 16) * 8);
      mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }

  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * os.s + col) = pack_bf16(acc[nb][0], acc[nb][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * os.s + col) = pack_bf16(acc[nb][2], acc[nb][3]);
  }
}

template <int KCH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                   int H, int S, Strides qs, Strides ks, Strides vs, Strides os,
                   int causal, cudaStream_t stream) {
  const int smem = (2 * KCH * 16 + QT) * LDS * static_cast<int>(sizeof(bf16));
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<KCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + QT - 1) / QT, H, B);
  attn_fwd_kernel<KCH><<<grid, 128, smem, stream>>>(
      q, k, v, o, S, qs, ks, vs, os, 1.0f / sqrtf(static_cast<float>(DH)), causal);
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
  if (S <= 64)
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
