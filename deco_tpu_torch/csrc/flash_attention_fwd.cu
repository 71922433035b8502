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
// are never stored. D is one of {64, 72, 128}; scale must be positive.
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
// Resources (ptxas and the CUDA runtime's `forward_kernel_info`, on an H100
// SXM), each instantiation without spills, 2 CTAs (8 warps) per SM:
//   D = 64:  242 registers, 72 KB of shared memory (2 Q tiles + 6 K/V);
//   D = 72:  244 registers (252 with lse), 72 KB;
//   D = 128: 224 registers, 85 KB (1 Q tile + 4 K/V).
//
// fp32 operands (`flash_fwd_f32_kernel`, `deco_flash_attention_fwd_f32`):
// the same function of fp32 q, k and v into fp32 o, forward only, D = 64.
// It replaces `_fwd_kernel` where it runs with fp32 operands (its
// `p.astype(v.dtype)` at :97 keeps P in fp32 then): the frozen DINOv2 tower
// of the REPA objectives (257 tokens at 256 px, 1,025 at 512 px; the JAX
// wrapper sends N % 8 != 0 to XLA, the port keeps its own kernel). Both
// products run on the fp32 SIMT units (67 TFLOP/s on an H100 SXM: no tensor
// core takes fp32 at full precision), so the bound is the operations:
// 4 * BH * Nq * Nkv * D FLOP, 6.5 GFLOP and 0.097 ms at B*H 384, N 257.
// Design: a CTA of 128 threads per (batch*head, 64 query rows); Q, the K
// and V tiles of 64 keys and P sit in shared memory (rows of 68 floats:
// 16-byte aligned, and the float4 reads of 8 rows 4 banks apart cover all
// 32 banks); thread (ty, tx) owns rows ty + 16i (i < 4), the keys tx + 8j
// (j < 8) of S and the output columns 4tx..4tx+3 and 32+4tx..32+4tx+3, so
// each shared-memory float4 feeds 8-16 FMAs. The online softmax is exact
// fp32 (exp2f, no flush), each row reduced over its 8 lanes by shuffles;
// keys past Nkv are zero-filled and masked to P = 0, rows past Nq are
// computed from zeros and not stored.

#include <math.h>

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

constexpr int kF32Rows = 64;  // query rows of a CTA, and keys of a tile
constexpr int kF32LD = 68;    // shared row stride in floats
constexpr int kF32Smem = 4 * kF32Rows * kF32LD * 4;  // Q, K, V and P: 69,632 bytes

// Rows [r0, r0 + 64) of one (tokens, D) fp32 operand into shared memory,
// rows at or past `n` as zeros; every thread of the CTA takes part.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int r0, int n) {
  constexpr int C4 = D / 4;
  for (int c = threadIdx.x; c < kF32Rows * C4; c += kThreads) {
    const int r = c / C4, ch = c % C4, row = r0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < n) val = *reinterpret_cast<const float4*>(src + row * stride + ch * 4);
    *reinterpret_cast<float4*>(dst + r * kF32LD + ch * 4) = val;
  }
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int heads, int nq,
                         int nkv, Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  static_assert(D == 64, "the fp32 forward maps 8 lanes x 8 columns onto D = 64");
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ks = qs + kF32Rows * kF32LD;
  float* vs = ks + kF32Rows * kF32LD;
  float* ps = vs + kF32Rows * kF32LD;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kF32Rows;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  load_rows_f32<D>(qs, q + b * sq.b + h * sq.h, sq.n, q0, nq);

  const float sl2 = scale * kLog2e;
  float m2[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m2[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  for (int j0 = 0; j0 < nkv; j0 += kF32Rows) {
    __syncthreads();  // every warp is done with the previous tile's K, V (and Q is stored)
    load_rows_f32<D>(ks, kp, sk.n, j0, nkv);
    load_rows_f32<D>(vs, vp, sv.n, j0, nkv);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kF32LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * kF32LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    const int valid = nkv - j0;  // only the last tile holds keys past the end
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (tx + 8 * j >= valid) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m2[i], mx * sl2);
      const float corr = exp2f(m2[i] - m_new);  // 0 on the first tile
      m2[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(fmaf(s[i][j], sl2, -m_new));
        sum += p;
        ps[(ty + 16 * i) * kF32LD + tx + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row of P is written and read by the 8 lanes of one warp

#pragma unroll 2
    for (int kk = 0; kk < kF32Rows; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kF32LD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v0 = *reinterpret_cast<const float4*>(vs + (kk + u) * kF32LD + 4 * tx);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + (kk + u) * kF32LD + 32 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = f4(pv[i], u);
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

  float* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < nq) {
      const float inv = 1.0f / l[i];
      *reinterpret_cast<float4*>(op + row * so.n + 4 * tx) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
      *reinterpret_cast<float4*>(op + row * so.n + 32 + 4 * tx) =
          make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int batch,
                       int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
                       Strides so, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<64>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kF32Rows - 1) / kF32Rows, batch * heads);
  flash_fwd_f32_kernel<64><<<grid, kThreads, kF32Smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), heads, nq, nkv, sq, sk, sv, so, scale);
  return cudaGetLastError();
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

// As deco_flash_attention_fwd, for fp32 q, k, v and o; head_dim must be 64.
int deco_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, int batch, int heads, int nq, int nkv,
                                 int head_dim, long long q_sb, long long q_sn,
                                 long long q_sh, long long k_sb, long long k_sn,
                                 long long k_sh, long long v_sb, long long v_sn,
                                 long long v_sh, long long o_sb, long long o_sn,
                                 long long o_sh, float scale, void* stream) {
  if (head_dim != 64 || !(scale > 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh};
  const Strides sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  return launch_f32(q, k, v, o, batch, heads, nq, nkv, sq, sk, sv, so, scale,
                    static_cast<cudaStream_t>(stream));
}

// What the current device makes of one kernel (kind 0: sampling, 1: with
// lse, 2: fp32 operands, D = 64 only): registers, local bytes, static and
// dynamic shared memory, resident CTAs per SM, threads, into out[0..5].
int deco_flash_attention_fwd_info(int lse, int head_dim, int* out) {
  if (lse == 2)
    return head_dim == 64 ? kernel_info(flash_fwd_f32_kernel<64>, kThreads, kF32Smem, out)
                          : static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
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
