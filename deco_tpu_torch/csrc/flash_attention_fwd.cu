// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernels `_fwd_kernel` (deco_tpu/ops/flash_attention.py:63,
// launched from `_flash_fwd` :252) and its streaming twin
// `_fwd_kernel_stream` (:109, launched from `_flash_fwd_stream` :190). Both
// compute the same function, non-causal O = softmax(scale * Q K^T) V per
// (batch, head); one kernel covers both here, because K/V always stream
// through shared memory in tiles.
//
// The LSE instantiation also replaces `_fwd_kernel_lse` (:270, launched from
// `_flash_fwd_lse` :319) and `_fwd_kernel_stream_lse` (:152): the forward of
// training, which also stores the fp32 row statistic lse = m + log(l) in the
// scaled-logit units of :304, shaped (B, H, Nq) contiguous, for the backward
// (flash_attention_bwd.cu, which reads it as lse * log2(e)).
//
// Layout: q is (B, Nq, H, D), k and v are (B, Nkv, H, D), o is (B, Nq, H, D).
// The kernel reads each operand in place through its (batch, token, head)
// strides, with the head dim contiguous, so no fold/unfold transposes run
// around it. Nq and Nkv are arbitrary: keys >= Nkv get P = 0 and rows >= Nq
// are never stored. D is one of {32, 64, 72, 128}; scale must be positive.
//
// Numerics follow the TPU kernel: QK^T and PV accumulate in fp32 on the
// tensor cores; the running max, running sum and the accumulator are fp32;
// P is rounded to bf16 before PV (`p.astype(v.dtype)`, :97); O = acc / l is
// rounded to bf16 once at the end. The exponentials are exp2 of
// s * (scale * log2 e) - m2, with m2 the running max in those units, and
// lse = (m2 + log2 l) * ln 2.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). The function moves
// q, k, v and o once (plus lse) and does 4 * BH * Nq * Nkv * D operations:
// - sampling, DeCo-XL/16 256 px with CFG at batch 8 (B*H 256, N 256,
//   D 72): 37.7 MB, 11.3 us, against 4.8 GFLOP, 4.9 us: bytes;
// - training at batch 32 (B*H 512, with lse): 76.0 MB, 22.7 us: bytes;
// - N = 4096 (B*H 16): 77.3 GFLOP, 78.2 us, against 37.7 MB: operations.
// At N = 256 each CTA sees only two to four key tiles, so the prologue and
// the epilogue weigh as much as the loop; at N = 4096 the loop is all, and
// with mma.sync the limit is the shared-memory reads of the K and V
// fragments and the exponentials, not the tensor cores.
//
// Design:
// - one CTA of 4 warps per (batch*head, 64 * row_tiles(D) query rows); each
//   warp owns row_tiles(D) tiles of 16 rows (rows 16w and 64 + 16w at
//   D <= 72) and keeps their Q A fragments in registers, loaded once by
//   ldmatrix. Every K and V fragment it loads feeds the MMAs of all its row
//   tiles, so two tiles halve the shared-memory reads per MMA; at D = 128
//   two would not fit in the registers;
// - K and V pass through a ring of `stages(D)` slots of 64 keys in dynamic
//   shared memory, filled by zero-filling 16-byte cp.async.cg copies (rows
//   past Nkv arrive as zeros); the Q tiles' copy goes out with the first
//   tiles', so the prologue overlaps, and one barrier a tile both publishes
//   tile j and frees the slot of tile j - 1 for refilling;
// - every fragment comes from ldmatrix: K's B fragments in the n-major
//   pattern and V's by ldmatrix.trans, so V stays row-major as it lies in
//   device memory;
// - the head dim is not padded: D = 72 takes four k16 steps and one m16n8k8
//   step in Q K^T and nine n8 tiles in P V (an x2 load for the ninth); a
//   row is an odd number of 16-byte chunks, which puts the eight rows of
//   every 8x8 ldmatrix in distinct banks;
// - the online softmax runs on the accumulator fragments in exp2 units, and
//   P goes from the Q K^T accumulators straight into the A operand of P V;
// - the epilogue writes each warp's O rows over its own Q rows in shared
//   memory and stores them as 16-byte chunks, whole rows per warp, and lse
//   as one 4-byte store per row.
// - D = 32 (the DC-AE decoder's attention in the bf16 VAE-GAN, 64 to 4,096
//   tokens) is the same code at two k16 steps and four n8 tiles: a 64-row
//   tile is 5 KB (rows of 40 bf16, five 16-byte chunks, so ldmatrix rows
//   still fall in distinct banks), the Q/K/V ring 40 KB. The row tiles,
//   stages and 2-CTA register cap were sized for D >= 64 and are kept.
// Resources (ptxas and the CUDA runtime's `forward_kernel_info`, on an H100
// SXM), each instantiation without spills, 2 CTAs (8 warps) per SM:
//   D = 64:  242 registers, 72 KB of shared memory (2 Q tiles + 6 K/V);
//   D = 72:  244 registers (252 with lse), 72 KB;
//   D = 128: 224 registers, 85 KB (1 Q tile + 4 K/V).
//
// fp32 operands (`flash_fwd_f32_kernel<D>`, `deco_flash_attention_fwd_f32`):
// the same function of fp32 q, k and v into fp32 o, forward only, for
// D = 32 and 64. It replaces `_fwd_kernel` where it runs with fp32 operands
// (its `p.astype(v.dtype)` at :97 keeps P in fp32 then): the frozen DINOv2
// tower of the REPA objectives (D = 64; 257 tokens at 256 px, 1,025 at 512
// px; the JAX wrapper sends N % 8 != 0 to XLA, the port keeps its own
// kernel) and the DC-AE's attention (D = 32, fp32 by default; 64 to 4,096
// tokens). Its notes are at the fp32 section below.
//
#include <math.h>

#include <atomic>

#include "attention_sm90.cuh"
#include "kernel_info.cuh"

using namespace deco;

namespace {

// m16 row tiles per warp (a CTA covers 64 * row_tiles(D) query rows, and
// each K/V fragment a warp loads serves that many MMAs), slots of the K/V
// ring, and the resident CTAs per SM each instantiation is compiled for
// (registers capped at 65536 / (ctas * kThreads)). At D = 128 two row
// tiles would spill.
__host__ __device__ constexpr int row_tiles(int d) { return d <= 72 ? 2 : 1; }
__host__ __device__ constexpr int stages(int d) { return d <= 72 ? 3 : 2; }
constexpr int kMinCtas = 2;

// The Q tiles, then the ring: K of tile j in slot j % S, V in S + j % S.
template <int D>
constexpr int fwd_smem_bytes() { return (row_tiles(D) + 2 * stages(D)) * Tile<D>::kBytes; }

// c[mt][16 x 64] += Q K^T for one key tile and each of the warp's MT row
// tiles: Q's A fragments in registers (`qa` over the k16 steps, `qa8` the
// k8 step of D = 72), K's 64 rows from `b`; every K fragment serves all MT.
template <int D, int MT = row_tiles(D)>
__device__ __forceinline__ void mma_qk(float (&c)[MT][kBlock / 8][4],
                                       const uint32_t (&qa)[MT][Tile<D>::K16][4],
                                       const uint32_t (&qa8)[MT][2], uint32_t b, int lane) {
  using T = Tile<D>;
  constexpr int LD = T::LD, NT = kBlock / 8;
  const uint32_t ob = 2 * lane_off_b<LD>(lane);
#pragma unroll
  for (int kk = 0; kk < T::K16; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm(bf, b + ob + 2 * (np * 16 * LD + kk * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(c[mt][2 * np], qa[mt][kk], bf[0], bf[1]);
        mma_16816(c[mt][2 * np + 1], qa[mt][kk], bf[2], bf[3]);
      }
    }
  if constexpr (T::K8) {
    constexpr int k0 = T::K16 * 16;
#pragma unroll
    for (int nq = 0; nq < NT / 4; ++nq) {
      uint32_t bf[4];
      ldsm(bf, b + 2 * ((nq * 32 + lane) * LD + k0));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_1688(c[mt][4 * nq + i], qa8[mt], bf[i]);
    }
  }
}

// acc[mt][16 x D] += P V for each row tile: P's A fragments a[mt], V's 16
// rows from `b` by ldmatrix.trans (the ninth n8 tile of D = 72 by an x2
// load), each V fragment serving all MT.
template <int D, int MT = row_tiles(D)>
__device__ __forceinline__ void mma_pv(float (&acc)[MT][Tile<D>::N8][4],
                                       const uint32_t (&a)[MT][4], uint32_t b, int lane) {
  using T = Tile<D>;
  const uint32_t oa = 2 * lane_off_a<T::LD>(lane);
#pragma unroll
  for (int np = 0; np < T::N8 / 2; ++np) {
    uint32_t bf[4];
    ldsm_t(bf, b + oa + 32 * np);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_16816(acc[mt][2 * np], a[mt], bf[0], bf[1]);
      mma_16816(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
    }
  }
  if constexpr (T::N8 % 2 != 0) {
    uint32_t bf[2];
    ldsm_t(bf, b + oa + 16 * (T::N8 - 1));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][T::N8 - 1], a[mt], bf[0], bf[1]);
  }
}

// The online softmax over one key tile, for rows g and g + 8 of the warp
// (this thread's columns 2t, 2t + 1 of each n8 tile): s holds the raw
// scores Q K^T and leaves holding P = exp2(s * sl2 - m2), with MASK giving
// P = 0 for keys at or past `valid`; m2 is the running max in units of
// s * sl2, l this thread's share of the running sum, and corr the factor
// by which the accumulator is to be rescaled. Needs sl2 > 0. Every tile
// holds a valid key, so the new max is finite, and the first tile's
// correction exp2(-inf) = 0.
template <bool MASK, int NK>
__device__ __forceinline__ void softmax_tile(float (&s)[NK][4], float (&m2)[2], float (&l)[2],
                                             float (&corr)[2], float sl2, int t, int valid) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && nt * 8 + 2 * t + (e & 1) >= valid) s[nt][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  float neg[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r] * sl2);
    corr[r] = exp2_ftz(m2[r] - m_new);
    m2[r] = m_new;
    neg[r] = -m_new;
  }
#pragma unroll
  for (int nt = 0; nt < NK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(fmaf(s[nt][e], sl2, neg[e >> 1]));
      s[nt][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

template <int D, bool LSE>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv, Strides so,
                     float scale) {
  using T = Tile<D>;
  constexpr int LD = T::LD, N8 = T::N8, S = stages(D), MT = row_tiles(D);
  constexpr int NK = kBlock / 8;  // n8 tiles over a key tile

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_u32(smem), qs = base;
  auto k_slot = [&](int j) { return base + (MT + j % S) * T::kBytes; };
  auto v_slot = [&](int j) { return base + (MT + S + j % S) * T::kBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * MT * kBlock;
  const int wr = warp * 16;  // this warp's first row in each 64-row tile
  const bf16* kp = k + b * sk.b + h * sk.h;
  const bf16* vp = v + b * sv.b + h * sv.h;
  const int ntiles = (nkv + kBlock - 1) / kBlock;
  auto copy_kv = [&](int j) {
    if (j < ntiles) {
      copy_rows<D>(k_slot(j), kp, sk.n, j * kBlock, nkv);
      copy_rows<D>(v_slot(j), vp, sv.n, j * kBlock, nkv);
    }
    cp_async_commit();  // possibly empty, so one group per tile
  };

  copy_rows<D, MT * kBlock>(qs, q + b * sq.b + h * sq.h, sq.n, q0, nq);  // joins tile 0's group
  for (int j = 0; j < S - 1; ++j) copy_kv(j);

  const float sl2 = scale * kLog2e;
  float m2[MT][2], l[MT][2];
  float acc[MT][N8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m2[mt][0] = m2[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.0f;
#pragma unroll
    for (int dt = 0; dt < N8; ++dt)
      acc[mt][dt][0] = acc[mt][dt][1] = acc[mt][dt][2] = acc[mt][dt][3] = 0.0f;
  }
  uint32_t qa[MT][T::K16][4], qa8[MT][2];

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<S - 2>();  // tile j (and Q) have landed for this thread ...
    __syncthreads();         // ... and for every thread, and every warp is done with tile j - 1
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t q_frag = qs + 2 * ((mt * kBlock + wr) * LD + lane_off_a<LD>(lane));
#pragma unroll
        for (int kk = 0; kk < T::K16; ++kk) ldsm(qa[mt][kk], q_frag + 32 * kk);
        if constexpr (T::K8) ldsm(qa8[mt], q_frag + 32 * T::K16);
      }
    }
    copy_kv(j + S - 1);  // into the slot of tile j - 1
    const uint32_t ks = k_slot(j), vs = v_slot(j);

    float s[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.0f;
    mma_qk<D>(s, qa, qa8, ks, lane);
    const int kvalid = nkv - j * kBlock;  // only the last tile can hold keys past the end
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float corr[2];
      if (kvalid >= kBlock)
        softmax_tile<false>(s[mt], m2[mt], l[mt], corr, sl2, t, kvalid);
      else
        softmax_tile<true>(s[mt], m2[mt], l[mt], corr, sl2, t, kvalid);
#pragma unroll
      for (int dt = 0; dt < N8; ++dt) {
        acc[mt][dt][0] *= corr[0];
        acc[mt][dt][1] *= corr[0];
        acc[mt][dt][2] *= corr[1];
        acc[mt][dt][3] *= corr[1];
      }
    }
    // O += P V: the S accumulators of n8 tiles 2kk and 2kk + 1 are exactly
    // the A fragment of the k16 step kk, rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc_to_a(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
      mma_pv<D>(acc, a, vs + 2 * kk * 16 * LD, lane);
    }
  }

  // Epilogue: O = acc / l over this warp's own Q rows in shared memory,
  // which no other warp reads, then out as 16-byte chunks, whole rows.
  __syncwarp();  // every lane's Q fragments are loaded before any O lands on them
  bf16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
    const float inv[2] = {1.0f / l[mt][0], 1.0f / l[mt][1]};
    const int r0 = mt * kBlock + wr;  // the tile's first row in the CTA
    bf16* orows = reinterpret_cast<bf16*>(smem) + r0 * LD;
#pragma unroll
    for (int dt = 0; dt < N8; ++dt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(orows + (g + 8 * r) * LD + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[mt][dt][2 * r] * inv[r], acc[mt][dt][2 * r + 1] * inv[r]);
    if constexpr (LSE) {
      if (t == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + r0 + g + 8 * r;
          if (row < nq)
            lse[static_cast<long long>(blockIdx.y) * nq + row] =
                (m2[mt][r] + log2f(l[mt][r])) * kLn2;
        }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < (16 * N8 + 31) / 32; ++i) {
      const int c = lane + 32 * i;
      const int r = c / N8, ch = c % N8, row = q0 + r0 + r;
      if ((16 * N8 % 32 == 0 || c < 16 * N8) && row < nq)
        *reinterpret_cast<uint4*>(op + row * so.n + ch * 8) =
            *reinterpret_cast<const uint4*>(orows + r * LD + ch * 8);
    }
  }
}

template <int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int batch, int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = row_tiles(D) * kBlock;
  const dim3 grid((nq + rows - 1) / rows, batch * heads);
  flash_fwd_kernel<D, LSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, heads, nq, nkv, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
             int heads, int nq, int nkv, int head_dim, Strides sq, Strides sk, Strides sv,
             Strides so, float scale, cudaStream_t st) {
  if (!(scale > 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32:
      return launch<32, LSE>(q, k, v, o, lse, batch, heads, nq, nkv, sq, sk, sv, so, scale, st);
    case 64:
      return launch<64, LSE>(q, k, v, o, lse, batch, heads, nq, nkv, sq, sk, sv, so, scale, st);
    case 72:
      return launch<72, LSE>(q, k, v, o, lse, batch, heads, nq, nkv, sq, sk, sv, so, scale, st);
    case 128:
      return launch<128, LSE>(q, k, v, o, lse, batch, heads, nq, nkv, sq, sk, sv, so, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
cudaError_t info(bool with_lse, int* out) {
  return with_lse ? kernel_info(flash_fwd_kernel<D, true>, kThreads, fwd_smem_bytes<D>(), out)
                  : kernel_info(flash_fwd_kernel<D, false>, kThreads, fwd_smem_bytes<D>(), out);
}

// ---- fp32 operands ------------------------------------------------------
//
// Bound. 4 * BH * Nq * Nkv * D operations on fp32 values: on the fp32 SIMT
// units (67 TFLOP/s on an H100 SXM) 0.0969 ms at B*H 384, N 257, D 64.
// This kernel runs them on the tensor cores instead, as 3xTF32: each
// operand x is split into TF32 parts, big = rna(x) and small = rna(x - big),
// so x = big + small to about 2^-22 |x|, and a b is taken as
// small_a big_b + big_a small_b + big_a big_b (the small_a small_b term,
// under 2^-22 |a b|, is dropped), accumulated in fp32. That is three TF32
// products a product, so its bound is 3 x the operations at 495 TFLOP/s
// TF32, 0.0394 ms at that shape, against the bytes of q, k, v and o at
// 3.35 TB/s, 0.0302 ms. One TF32 pass would keep about 3 decimal digits:
// the output would move past its 1e-5 x max|v| gate
// (tests/test_torch_fp32_split.py emulates both in numpy).
//
// Design:
// - a CTA of 4 warps per (batch*head, 64 query rows); each warp owns 16
//   rows, keeps their Q fragments split into big and small in registers
//   (read once from device memory), and skips its MMAs when its rows all
//   lie past Nq;
// - Q K^T and P V run as mma.sync m16n8k8 .tf32, three per product;
// - K and V stream through shared memory in tiles of 32 keys. Each thread
//   copies its share of tile j + 1 with zero-filling 16-byte cp.async.cg
//   into a staging area that only it reads, while the CTA computes tile j
//   (keys past Nkv arrive as zeros). At tile j each thread splits the
//   chunks it copied into the big and small planes of K (key-major, rows of
//   D + 4 floats) and of V^T (dim-major, rows of 36 floats), once for all
//   four warps. Two barriers a tile: the planes are free, the planes are
//   written;
// - every B fragment comes from one ldmatrix.x4 (b16 matrices read as
//   8 rows x 4 floats: lane 4g + t gets element t of row g), big and small
//   of both registers at once. Row strides of 272 and 144 bytes (16 mod
//   128) put the 8 rows of each matrix in distinct banks;
// - P stays in registers: the accumulator holds keys 2t, 2t + 1 of rows
//   g, g + 8, and the A fragment wants columns t, t + 4, so column t is
//   taken to be key 2t and column t + 4 key 2t + 1 (a = c0, c2, c1, c3).
//   V^T stores key 2e at position e and key 2e + 1 at 4 + e of each group
//   of 8, so ldmatrix hands each lane V rows 2t and 2t + 1. The split
//   writes V^T from 16 keys x 2 chunks a warp, into 32 distinct banks;
// - the last key tile runs only the n8 blocks that hold a key and masks
//   the rest of its last block; a warp's partial 16 rows are computed from
//   zero rows and not stored. At N 257 that is 1.09x the useful work;
// - the MMAs of one pass go over all n8 blocks before the next pass, so
//   consecutive MMAs write different accumulators;
// - the online softmax is the bf16 kernel's (exp2 units, fp32 statistics).
//   That is a change from the SIMT kernel this one replaces, which took P
//   from exact exp2f: P now comes from ex2.approx.ftz. Its relative error is
//   on the order of 2^-22, the size of the 3xTF32 products' own, and the
//   values it flushes to zero (below 2^-126) are negligible beside
//   l >= 1, so the output stays within its 1e-5 x max|v| gate;
//   O = acc / l goes out as float2 straight from the accumulators. No
//   atomics, so the output is bit-identical run to run;
// - the shared-memory opt-in is set once per device, not at every launch.
// Shared memory: 52 KB at D = 64, 26 KB at D = 32; the registers (about
// 240 and 160) allow 2 and 3 CTAs an SM.
// Next step, not taken: wgmma at TF32, which reads B K-major from shared
// memory, so P V needs V^T there as now, in wgmma's swizzled layout, with
// 64-row warpgroup tiles of Q.

// Keys of a K/V tile. With 64 the D = 64 instantiation needs more than 255
// registers and spills, and on the card it ran slower than with 32; a
// second set of planes (the split of tile j + 1 beside the MMAs of tile j,
// one barrier a tile) ran no faster and was left out.
constexpr int kF32Keys = 32;

template <int D>
struct F32Tile {
  static_assert(D == 32 || D == 64, "the fp32 forward is built for D = 32 and 64");
  static constexpr int KT = kF32Keys;
  static constexpr int K8 = D / 8;                     // k8 steps of Q K^T; n8 blocks of P V
  static constexpr int C4 = D / 4;                     // 16-byte chunks in a row
  static constexpr int LDK = D + 4;                    // K planes: (key, dim)
  static constexpr int LDV = KT + 4;                   // V^T planes: (dim, key position)
  static constexpr int kChunks = KT * C4 / kThreads;   // chunks a thread copies per operand
  static constexpr int kRaw = KT * D;                  // floats of one operand's staging
  static constexpr int kK = KT * LDK;                  // floats of one K plane
  static constexpr int kV = D * LDV;                   // floats of one V^T plane
  static constexpr int kSmemBytes = 4 * (2 * kRaw + 2 * kK + 2 * kV);
  static constexpr int kGroups = KT / 16;              // 16-key groups of a V tile
  static_assert(kChunks * kThreads == KT * C4 && kThreads / 32 % kGroups == 0, "copy map");
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each TF32, to about 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float4& x, uint4& big, uint4& small) {
  split_tf32(x.x, big.x, small.x);
  split_tf32(x.y, big.y, small.y);
  split_tf32(x.z, big.z, small.z);
  split_tf32(x.w, big.w, small.w);
}

// d += a * b for one 16x8x8 TF32 tile (A row-major 16x8, B column-major 8x8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three products of 3xTF32 over n8 blocks [0, nb) (all N unless
// PARTIAL): acc[n] += A B_n with A = big + small (ab, as), B_n's big
// fragment in b[n][0..1] and its small one in b[n][2..3]. Each pass runs
// over every block before the next, so consecutive MMAs are independent.
template <bool PARTIAL, int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[N][4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&b)[N][4],
                                           int nb) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (!PARTIAL || n < nb) mma_tf32(acc[n], as, b[n][0], b[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (!PARTIAL || n < nb) mma_tf32(acc[n], ab, b[n][2], b[n][3]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (!PARTIAL || n < nb) mma_tf32(acc[n], ab, b[n][0], b[n][1]);
}

// One key tile for one warp's 16 rows: S = Q K^T from the K planes at
// `kaddr` (this lane's ldmatrix address), the online softmax, acc += P V
// from the V^T planes at `vaddr`. PARTIAL: the last tile, `valid` < KT keys.
template <int D, bool PARTIAL>
__device__ __forceinline__ void f32_tile(float (&acc)[D / 8][4], float (&m2)[2], float (&l)[2],
                                         const uint32_t (&qb)[D / 8][4],
                                         const uint32_t (&qs)[D / 8][4], uint32_t kaddr,
                                         uint32_t vaddr, float sl2, int t, int valid) {
  using T = F32Tile<D>;
  constexpr int NK = T::KT / 8;
  const int nb = PARTIAL ? (valid + 7) / 8 : NK;  // n8 blocks that hold a key

  float s[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < T::K8; ++kk) {
    uint32_t b[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
      if (!PARTIAL || n < nb) ldsm(b[n], kaddr + 4 * (n * 8 * T::LDK + kk * 8));
    mma_3xtf32<PARTIAL>(s, qb[kk], qs[kk], b, nb);
  }

  float corr[2];
  softmax_tile<PARTIAL>(s, m2, l, corr, sl2, t, valid);
#pragma unroll
  for (int n = 0; n < T::K8; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }

#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (PARTIAL && kk >= nb) break;
    uint32_t pb[4], ps[4];
    split_tf32(s[kk][0], pb[0], ps[0]);  // column t: key 2t of row g ...
    split_tf32(s[kk][2], pb[1], ps[1]);  // ... and of row g + 8
    split_tf32(s[kk][1], pb[2], ps[2]);  // column t + 4: key 2t + 1
    split_tf32(s[kk][3], pb[3], ps[3]);
    uint32_t b[T::K8][4];
#pragma unroll
    for (int n = 0; n < T::K8; ++n) ldsm(b[n], vaddr + 4 * (n * 8 * T::LDV + kk * 8));
    mma_3xtf32<false>(acc, pb, ps, b, T::K8);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int heads, int nq,
                         int nkv, Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  using T = F32Tile<D>;
  constexpr int K8 = T::K8, C4 = T::C4, KT = T::KT;
  extern __shared__ __align__(16) float fsm[];
  float* raw_k = fsm;  // staging, in the order each thread copies
  float* raw_v = raw_k + T::kRaw;
  float* planes = raw_v + T::kRaw;  // K big, K small, V^T big, V^T small

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int r0 = blockIdx.x * kBlock + 16 * warp;  // this warp's first query row
  const bool active = r0 < nq;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  const int ntiles = (nkv + KT - 1) / KT;
  // V chunks: a warp copies 16 keys x 2 adjacent chunks (32-byte sectors)
  // at a time, so this thread's key is fixed and the V^T stores of one dim
  // fall in 32 distinct banks across the warp.
  const int vkey = 16 * (warp % T::kGroups) + lane / 2;
  const int vpos = (vkey & ~7) | ((vkey & 7) >> 1) | ((vkey & 1) << 2);
  auto vchunk = [&](int i) { return 2 * ((warp + kWarps * i) / T::kGroups) + (lane & 1); };

  auto copy_tile = [&](int j) {
    const int key0 = j * KT;
#pragma unroll
    for (int i = 0; i < T::kChunks; ++i) {
      const int id = tid + kThreads * i, r = id / C4, c = id % C4;
      const bool ok = key0 + r < nkv, okv = key0 + vkey < nkv;
      cp_async16(smem_u32(raw_k + 4 * id), kp + (ok ? (key0 + r) * sk.n + 4 * c : 0), ok);
      cp_async16(smem_u32(raw_v + 4 * id),
                 vp + (okv ? (key0 + vkey) * sv.n + 4 * vchunk(i) : 0), okv);
    }
    cp_async_commit();
  };
  auto split_tile = [&]() {
    float* kb = planes;
    uint32_t* vt = reinterpret_cast<uint32_t*>(kb + 2 * T::kK) + vpos;
#pragma unroll
    for (int i = 0; i < T::kChunks; ++i) {
      const int id = tid + kThreads * i, r = id / C4, c = id % C4;
      uint4 big, small;
      split4(*reinterpret_cast<const float4*>(raw_k + 4 * id), big, small);
      *reinterpret_cast<uint4*>(kb + r * T::LDK + 4 * c) = big;
      *reinterpret_cast<uint4*>(kb + T::kK + r * T::LDK + 4 * c) = small;
      split4(*reinterpret_cast<const float4*>(raw_v + 4 * id), big, small);
      const uint32_t bigs[4] = {big.x, big.y, big.z, big.w};
      const uint32_t smalls[4] = {small.x, small.y, small.z, small.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vt[(4 * vchunk(i) + e) * T::LDV] = bigs[e];
        vt[T::kV + (4 * vchunk(i) + e) * T::LDV] = smalls[e];
      }
    }
  };

  copy_tile(0);

  // Q's A fragments (rows g, g + 8; columns t, t + 4 of each k8 step), split
  uint32_t qb[K8][4], qs[K8][4];
  if (active) {
    const float* qp = q + b * sq.b + h * sq.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1);
      const float* qr = qp + (row < nq ? row * sq.n : 0) + t + 4 * (i >> 1);
#pragma unroll
      for (int kk = 0; kk < K8; ++kk)
        split_tf32(row < nq ? __ldg(qr + 8 * kk) : 0.0f, qb[kk][i], qs[kk][i]);
    }
  }

  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[K8][4];
#pragma unroll
  for (int n = 0; n < K8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const float sl2 = scale * kLog2e;
  // ldmatrix.x4 rows: lanes 8i..8i+7 address matrix i, in the big (i < 2)
  // or the small plane, at column +0 (i even) or +4
  const int mi = lane / 8;
  const uint32_t kaddr =
      smem_u32(planes) + 4 * ((mi >> 1) * T::kK + (lane % 8) * T::LDK + 4 * (mi & 1));
  const uint32_t vaddr = smem_u32(planes) +
                         4 * (2 * T::kK + (mi >> 1) * T::kV + (lane % 8) * T::LDV + 4 * (mi & 1));
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();  // this thread's chunks of tile j have landed
    __syncthreads();     // every warp is done with tile j - 1's planes
    split_tile();
    asm volatile("" ::: "memory");  // the staging is read before it is refilled
    if (j + 1 < ntiles) copy_tile(j + 1);
    __syncthreads();  // tile j's planes are whole
    if (active) {
      const int valid = nkv - j * KT;
      if (valid >= KT)
        f32_tile<D, false>(acc, m2, l, qb, qs, kaddr, vaddr, sl2, t, valid);
      else
        f32_tile<D, true>(acc, m2, l, qb, qs, kaddr, vaddr, sl2, t, valid);
    }
  }
  if (!active) return;

  float* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / l[r];
    const int row = r0 + g + 8 * r;
    if (row < nq)
#pragma unroll
      for (int n = 0; n < K8; ++n)
        *reinterpret_cast<float2*>(op + row * so.n + 8 * n + 2 * t) =
            make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

// The dynamic shared memory opt-in, set once per device for each
// instantiation rather than at every launch.
template <int D>
cudaError_t f32_smem_once() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, F32Tile<D>::kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int batch,
                       int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
                       Strides so, float scale, cudaStream_t stream) {
  cudaError_t err = f32_smem_once<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlock - 1) / kBlock, batch * heads);
  flash_fwd_f32_kernel<D><<<grid, kThreads, F32Tile<D>::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), heads, nq, nkv, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t info_f32(int* out) {
  return kernel_info(flash_fwd_f32_kernel<D>, kThreads, F32Tile<D>::kSmemBytes, out);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Strides are in elements; the head dim of every operand has stride 1.
int deco_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int batch, int heads, int nq, int nkv,
                             int head_dim, long long q_sb, long long q_sn,
                             long long q_sh, long long k_sb, long long k_sn,
                             long long k_sh, long long v_sb, long long v_sn,
                             long long v_sh, long long o_sb, long long o_sn,
                             long long o_sh, float scale, void* stream) {
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh};
  const Strides sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  return dispatch<false>(q, k, v, o, nullptr, batch, heads, nq, nkv, head_dim,
                         sq, sk, sv, so, scale, static_cast<cudaStream_t>(stream));
}

// As deco_flash_attention_fwd, and also writes lse, fp32 (B, H, Nq) contiguous.
int deco_flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int batch, int heads,
                                 int nq, int nkv, int head_dim, long long q_sb,
                                 long long q_sn, long long q_sh, long long k_sb,
                                 long long k_sn, long long k_sh, long long v_sb,
                                 long long v_sn, long long v_sh, long long o_sb,
                                 long long o_sn, long long o_sh, float scale,
                                 void* stream) {
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh};
  const Strides sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  return dispatch<true>(q, k, v, o, static_cast<float*>(lse), batch, heads, nq,
                        nkv, head_dim, sq, sk, sv, so, scale,
                        static_cast<cudaStream_t>(stream));
}

// As deco_flash_attention_fwd, for fp32 q, k, v and o; head_dim 32 or 64.
int deco_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, int batch, int heads, int nq, int nkv,
                                 int head_dim, long long q_sb, long long q_sn,
                                 long long q_sh, long long k_sb, long long k_sn,
                                 long long k_sh, long long v_sb, long long v_sn,
                                 long long v_sh, long long o_sb, long long o_sn,
                                 long long o_sh, float scale, void* stream) {
  if (!(scale > 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh};
  const Strides sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_f32<32>(q, k, v, o, batch, heads, nq, nkv, sq, sk, sv, so, scale, st);
    case 64:
      return launch_f32<64>(q, k, v, o, batch, heads, nq, nkv, sq, sk, sv, so, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What the current device makes of one kernel (kind 0: sampling, 1: with
// lse, both at D = 32, 64, 72 or 128; 2: fp32 operands, D = 32 or 64):
// registers, local bytes, static and dynamic shared memory, resident CTAs
// per SM, threads, into out[0..5].
int deco_flash_attention_fwd_info(int lse, int head_dim, int* out) {
  if (lse == 2) {
    switch (head_dim) {
      case 32:
        return info_f32<32>(out);
      case 64:
        return info_f32<64>(out);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (head_dim) {
    case 32:
      return info<32>(lse != 0, out);
    case 64:
      return info<64>(lse != 0, out);
    case 72:
      return info<72>(lse != 0, out);
    case 128:
      return info<128>(lse != 0, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* deco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
