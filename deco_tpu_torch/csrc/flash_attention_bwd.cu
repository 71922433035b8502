// Flash-attention backward for Hopper (sm_90a): dQ with delta, and dK with dV, bf16.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (deco_tpu/ops/flash_attention.py:344,
// launched from `_flash_bwd_pallas` :549) with its streaming twin
// `_bwd_dq_kernel_stream` (:421), and `_bwd_dkv_kernel` (:379, launched at
// :562) with `_bwd_dkv_kernel_stream` (:454). One kernel covers each pair,
// because the streamed operands always pass through shared memory in tiles.
//
// Both recompute P = exp(scale * Q K^T - lse) from the forward's fp32 lse
// (flash_attention_fwd.cu, LSE instantiation):
//   delta = rowsum(dO * O), dQ = scale * [P o (dO V^T - delta)] K    (dq kernel)
//   dV = P^T dO,  dK = scale * [P o (dO V^T - delta)]^T Q             (dkv kernel)
// delta is XLA in the JAX package (`_flash_core_bwd`, :623); here the dq
// kernel computes it in fp32 for its query tile in its prologue, uses it,
// and writes it out (B, H, Nq) for the dkv kernel, launched after it on the
// same stream. Rounding follows the TPU kernels: dS is rounded to bf16
// before dS K and dS^T Q (:368, :408), P before P^T dO (:401); the
// accumulators are fp32 and dQ, dK are scaled at the end (:376, :417), then
// rounded to bf16.
//
// Layout and conventions are the forward's: q, o, do, dq are (B, Nq, H, D),
// k, v, dk, dv are (B, Nkv, H, D), each read or written in place through its
// (batch, token, head) strides with the head dim contiguous; lse and delta
// are fp32 (B, H, Nq) contiguous; D is one of {32, 64, 72, 128}; ragged Nq, Nkv
// and Nq != Nkv are masked in the kernel (P = 0 for keys >= Nkv and for
// queries >= Nq).
//
// Bound on an H100 SXM at the training shape (DeCo-XL/16, 256 px, batch 32:
// B*H = 512, N = 256, D = 72; one bf16 operand is 18.9 MB): dQ with delta
// moves q, k, v, o, do, dq + lse, delta = 114.3 MB, 34.1 us at 3.35 TB/s,
// and does 6*BH*N^2*D = 14.5 GFLOP, 14.7 us at 989 TFLOP/s; dK/dV moves
// the same 114.3 MB and does 19.3 GFLOP, 19.5 us. Both are memory-bound.
//
// Design:
// - dQ: one CTA of 4 warps per (batch*head, 64-query tile), as the Pallas
//   grid (bh, q blocks); dK/dV: one CTA per (batch*head, 64-key tile). Each
//   output row is owned by one CTA, so no atomics are needed and the
//   gradients are bit-identical from run to run.
// - The stationary tiles (Q and dO in dQ; K and V in dK/dV) stay in shared
//   memory and are read by `ldmatrix` at each use rather than pinned in
//   registers. The streamed tiles (K, V in dQ; Q, dO, lse, delta in dK/dV)
//   pass through a ring of `stages(D)` slots in dynamic shared memory,
//   filled by 16-byte `cp.async.cg` copies (4-byte ones for lse and delta,
//   whose rows need not be 16-byte aligned): while tile t is multiplied,
//   tiles t + 1 .. t + stages - 1 are in flight, and one barrier a tile both
//   publishes tile t and frees the slot of tile t - 1 for refilling. Rows
//   past the end are zero-filled by the copy itself.
// - All fragments come from `ldmatrix`: A operands and the B operands read
//   along a row (K in Q K^T, V in dO V^T, Q and dO in the transposed
//   scores), and `ldmatrix.trans` for the B operands read down the token
//   axis (K in dS K, dO in P^T dO, Q in dS^T Q).
// - The head dim is not padded: D = 72 takes four k16 steps and one
//   m16n8k8 step over D, and nine n8 tiles (an x2 load for the ninth), so no
//   MMA or load touches a column past D. A row is an odd number of 16-byte
//   chunks (72 bf16 for D = 64 and 72, 136 for 128), which puts the eight
//   rows of each 8x8 ldmatrix in distinct banks.
// - The products are `mma.sync` bf16 -> fp32. The dK/dV kernel forms P^T,
//   dP^T and dS^T for two parts of 32 queries in turn, to keep its registers
//   (two fp32 accumulators of 16 x D) within 168 a thread, so three CTAs (12
//   warps) fit on an SM at D <= 72, with a three-slot ring (72-73.5 KB of
//   shared memory a CTA).
// - D = 32 (the DC-AE decoder's attention in the bf16 VAE-GAN) is the same
//   code at two k16 steps and four n8 tiles over D: 5 KB tiles, so both
//   kernels keep the D <= 72 sizing (three slots, three CTAs an SM) with
//   less than half its shared memory.
// The tile layout, copies, fragment loads and MMA tiles it shares with the
// forward are in attention_sm90.cuh.

#include <math.h>

#include "attention_sm90.cuh"
#include "kernel_info.cuh"

using namespace deco;

namespace {

// Resident CTAs per SM that each kernel is compiled for (the registers are
// capped at 65536 / (ctas * kThreads)), and the slots of its ring; shared
// memory holds three CTAs with three slots up to D = 72, two with two at 128.
__host__ __device__ constexpr int min_ctas(int d) { return d <= 72 ? 3 : 2; }
__host__ __device__ constexpr int stages(int d) { return d <= 72 ? 3 : 2; }

// Both kernels hold 2 + 2 * stages tiles; dK/dV also rings lse and delta.
template <int D>
constexpr int dq_smem_bytes() { return (2 + 2 * stages(D)) * Tile<D>::kBytes; }
template <int D>
constexpr int dkv_smem_bytes() {
  return (2 + 2 * stages(D)) * Tile<D>::kBytes + 2 * stages(D) * kBlock * 4;
}

// c[16 x 8 NT] += A B^T over the head dim: A the 16 rows of a tile from
// shared-memory address `a`, B the 8 NT rows of a tile from `b`. The k8 step
// (D = 72) loads B by one ldmatrix.x4 per 32 rows, one row per lane.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], uint32_t a, uint32_t b, int lane) {
  static_assert(NT % 4 == 0, "B is loaded 32 rows at a time");
  using T = Tile<D>;
  constexpr int LD = T::LD;
  const uint32_t oa = 2 * lane_off_a<LD>(lane), ob = 2 * lane_off_b<LD>(lane);
#pragma unroll
  for (int kk = 0; kk < T::K16; ++kk) {
    uint32_t af[4];
    ldsm(af, a + oa + 32 * kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm(bf, b + ob + 2 * (np * 16 * LD + kk * 16));
      mma_16816(c[2 * np], af, bf[0], bf[1]);
      mma_16816(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  if constexpr (T::K8) {
    constexpr int k0 = T::K16 * 16;
    uint32_t af[2];
    ldsm(af, a + oa + 2 * k0);
#pragma unroll
    for (int nq = 0; nq < NT / 4; ++nq) {
      uint32_t bf[4];
      ldsm(bf, b + 2 * ((nq * 32 + lane) * LD + k0));
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_1688(c[4 * nq + i], af, bf[i]);
    }
  }
}

// acc[16 x D] += A B: A (16 x 16) a bf16 fragment in registers, B the 16
// rows of a tile from shared-memory address `b`, read down its rows by
// ldmatrix.trans; the ninth n8 tile of D = 72 takes an x2 load.
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[Tile<D>::N8][4], const uint32_t (&a)[4],
                                       uint32_t b, int lane) {
  using T = Tile<D>;
  const uint32_t oa = 2 * lane_off_a<T::LD>(lane);
#pragma unroll
  for (int np = 0; np < T::N8 / 2; ++np) {
    uint32_t bf[4];
    ldsm_t(bf, b + oa + 32 * np);
    mma_16816(acc[2 * np], a, bf[0], bf[1]);
    mma_16816(acc[2 * np + 1], a, bf[2], bf[3]);
  }
  if constexpr (T::N8 % 2 != 0) {
    uint32_t bf[2];
    ldsm_t(bf, b + oa + 16 * (T::N8 - 1));
    mma_16816(acc[T::N8 - 1], a, bf[0], bf[1]);
  }
}

// 64 fp32 row statistics [i0, i0 + 64) into `dst`, zero past `valid`.
__device__ __forceinline__ void copy_stats(uint32_t dst, const float* src, int i0, int valid) {
  const int i = threadIdx.x;
  if (i < kBlock) cp_async4(dst + 4 * i, src + (i0 + i < valid ? i0 + i : 0), i0 + i < valid);
}

// dS = P o (dP - delta) in place of s, for a warp's 16 query rows (g and
// g + 8 of this thread) and the 8 * NK keys of a tile, where P = exp(scale *
// s - lse) as exp2(s * scale_log2 - lse_log2); with MASK, P = 0 for keys
// (columns) at or past `valid`.
template <bool MASK, int NK>
__device__ __forceinline__ void ds_rows(float (&s)[NK][4], const float (&dp)[NK][4],
                                        const float (&lse_log2)[2], const float (&delta)[2],
                                        float scale_log2, int t, int valid) {
#pragma unroll
  for (int nt = 0; nt < NK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(fmaf(s[nt][e], scale_log2, -lse_log2[e >> 1]));
      if (MASK && nt * 8 + 2 * t + (e & 1) >= valid) p = 0.0f;
      s[nt][e] = p * (dp[nt][e] - delta[e >> 1]);
    }
}

// P^T = exp(scale * s - lse) in place of s, for a warp's 16 key rows and the
// 8 * NQ queries (columns) of a tile, whose lse the tile's `lse` holds; with
// MASK, P = 0 for queries at or past `valid`.
template <bool MASK, int NQ>
__device__ __forceinline__ void p_cols(float (&s)[NQ][4], const float* lse, float scale_log2,
                                       int t, int valid) {
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = nt * 8 + 2 * t + (e & 1);
      const float p = exp2_ftz(fmaf(s[nt][e], scale_log2, lse[qi] * -kLog2e));
      s[nt][e] = MASK && qi >= valid ? 0.0f : p;
    }
}

// Rows [row, row + 8) and [row + 8, row + 16) of acc * mul, as bf16, for rows < valid.
template <int N8>
__device__ __forceinline__ void store_rows(bf16* base, Strides s, int b, int h, int row,
                                           int valid, const float (&acc)[N8][4], float mul,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row + 8 * r;
    if (n >= valid) continue;
    bf16* out = base + b * s.b + n * s.n + h * s.h;
#pragma unroll
    for (int dt = 0; dt < N8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas(D))
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const bf16* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int heads, int nq,
                        int nkv, Strides sq, Strides sk, Strides sv, Strides sdo, Strides so,
                        Strides sdq, float scale) {
  using T = Tile<D>;
  constexpr int LD = T::LD, N8 = T::N8, S = stages(D);
  constexpr int NK = kBlock / 8;  // n8 tiles over a key tile

  // Tiles: Q, dO, then the ring: K of tile j in slot 2 + j % S, V in 2 + S + j % S.
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t qs = base, dos = base + T::kBytes;
  auto k_slot = [&](int j) { return base + (2 + j % S) * T::kBytes; };
  auto v_slot = [&](int j) { return base + (2 + S + j % S) * T::kBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlock;
  const int wr = warp * 16;  // this warp's first row in the tile
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

  copy_rows<D>(qs, q + b * sq.b + h * sq.h, sq.n, q0, nq);
  copy_rows<D>(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, nq);
  cp_async_commit();

  // delta = rowsum(dO * O) for the warp's 16 rows: lanes 2i and 2i + 1 sum
  // alternate 16-byte chunks of row i, O from device memory, dO from the tile.
  constexpr int OCH = (N8 + 1) / 2;
  const int drow = wr + lane / 2;
  const bool drow_ok = q0 + drow < nq;
  uint4 ov[OCH];
  {
    const bf16* orow = o + b * so.b + h * so.h + (drow_ok ? (q0 + drow) * so.n : 0);
#pragma unroll
    for (int i = 0; i < OCH; ++i) {
      const int ch = lane % 2 + 2 * i;
      ov[i] = drow_ok && ch < N8 ? __ldg(reinterpret_cast<const uint4*>(orow + ch * 8))
                                 : make_uint4(0, 0, 0, 0);
    }
  }
  const float scale_log2 = scale * kLog2e;
  float row_lse_log2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + wr + g + 8 * r;
    row_lse_log2[r] = n < nq ? lse[static_cast<long long>(blockIdx.y) * nq + n] * kLog2e : 0.0f;
  }
  // The ring's first tiles are issued after the O and lse loads, which
  // would otherwise queue behind them.
  for (int j = 0; j < S - 1; ++j) copy_kv(j);
  cp_async_wait<S - 1>();  // Q and dO have landed; the ring's tiles may be in flight
  __syncthreads();
  float dsum = 0.0f;
  const bf16* do_row = reinterpret_cast<const bf16*>(smem + T::kBytes) + drow * LD;
#pragma unroll
  for (int i = 0; i < OCH; ++i) {
    const int ch = lane % 2 + 2 * i;
    if (ch < N8) {
      const uint4 dv = *reinterpret_cast<const uint4*>(do_row + ch * 8);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(x[e]), yf = __bfloat1622float2(y[e]);
        dsum += xf.x * yf.x + xf.y * yf.y;
      }
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (lane % 2 == 0 && drow_ok) delta[static_cast<long long>(blockIdx.y) * nq + q0 + drow] = dsum;
  const float row_delta[2] = {__shfl_sync(0xffffffffu, dsum, 2 * g),
                              __shfl_sync(0xffffffffu, dsum, 2 * g + 16)};

  float acc[N8][4];
#pragma unroll
  for (int dt = 0; dt < N8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<S - 2>();  // tile j has landed for this thread ...
    __syncthreads();         // ... and for every thread, and every warp is done with tile j - 1
    copy_kv(j + S - 1);      // into the slot of tile j - 1
    const uint32_t ks = k_slot(j), vs = v_slot(j);

    // S = Q K^T and dP = dO V^T for the warp's 16 rows and the tile's 64 keys.
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
    mma_abt<D>(s, qs + 2 * wr * LD, ks, lane);
    mma_abt<D>(dp, dos + 2 * wr * LD, vs, lane);
    // dS = P o (dP - delta); only the last tile can hold keys past the end.
    const int kvalid = nkv - j * kBlock;
    if (kvalid >= kBlock)
      ds_rows<false>(s, dp, row_lse_log2, row_delta, scale_log2, t, kvalid);
    else
      ds_rows<true>(s, dp, row_lse_log2, row_delta, scale_log2, t, kvalid);
    // dQ += dS K: dS (bf16) is the A operand, K read down its key axis.
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_ab<D>(acc, a, ks + 2 * kk * 16 * LD, lane);
    }
  }
  store_rows(dq, sdq, b, h, q0 + wr + g, nq, acc, scale, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas(D))
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int nq,
                         int nkv, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, float scale) {
  using T = Tile<D>;
  constexpr int LD = T::LD, N8 = T::N8, S = stages(D);
  // P^T and dS^T are formed for one part of a query tile at a time, which
  // keeps two fp32 accumulators of 16 x D and the part's P^T within 168
  // registers at the cost of loading K's A fragments once per part.
  constexpr int kParts = 2;
  constexpr int NP = kBlock / 8 / kParts;  // n8 tiles over one part

  // Tiles: K, V, then the ring: Q of tile j in slot 2 + j % S, dO in
  // 2 + S + j % S; after the tiles, lse of tile j at [(j % S) * 64, ...),
  // delta after all lse.
  extern __shared__ __align__(16) unsigned char smem[];
  const float* stats = reinterpret_cast<const float*>(smem + (2 + 2 * S) * T::kBytes);
  const uint32_t base = smem_u32(smem), stats_u32 = smem_u32(stats);
  const uint32_t ks = base, vs = base + T::kBytes;
  auto q_slot = [&](int j) { return base + (2 + j % S) * T::kBytes; };
  auto do_slot = [&](int j) { return base + (2 + S + j % S) * T::kBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kBlock;
  const int wr = warp * 16;
  const bf16* qp = q + b * sq.b + h * sq.h;
  const bf16* dop = dout + b * sdo.b + h * sdo.h;
  const float* lse_p = lse + static_cast<long long>(blockIdx.y) * nq;
  const float* delta_p = delta + static_cast<long long>(blockIdx.y) * nq;
  const int ntiles = (nq + kBlock - 1) / kBlock;
  const float scale_log2 = scale * kLog2e;

  auto copy_tile = [&](int j) {
    if (j < ntiles) {
      copy_rows<D>(q_slot(j), qp, sq.n, j * kBlock, nq);
      copy_rows<D>(do_slot(j), dop, sdo.n, j * kBlock, nq);
      copy_stats(stats_u32 + 4 * (j % S) * kBlock, lse_p, j * kBlock, nq);
      copy_stats(stats_u32 + 4 * (S + j % S) * kBlock, delta_p, j * kBlock, nq);
    }
    cp_async_commit();  // possibly empty, so one group per tile
  };

  copy_rows<D>(ks, k + b * sk.b + h * sk.h, sk.n, k0, nkv);
  copy_rows<D>(vs, v + b * sv.b + h * sv.h, sv.n, k0, nkv);
  cp_async_commit();
  for (int j = 0; j < S - 1; ++j) copy_tile(j);

  float dk_acc[N8][4], dv_acc[N8][4];
#pragma unroll
  for (int dt = 0; dt < N8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.0f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<S - 2>();  // tile j (and K, V) have landed for this thread ...
    __syncthreads();         // ... and for every thread, and every warp is done with tile j - 1
    copy_tile(j + S - 1);    // into the slot of tile j - 1
    const uint32_t qs = q_slot(j), dos = do_slot(j);
    const float* lse_s = stats + (j % S) * kBlock;
    const float* delta_s = stats + (S + j % S) * kBlock;
    const int qvalid = nq - j * kBlock;  // only the last tile can hold queries past the end

    // One part of the tile's queries at a time, for the warp's 16 keys (rows);
    // a rolled loop, so that the parts' registers are not live together.
#pragma unroll 1
    for (int part = 0; part < kParts; ++part) {
      const int h0 = part * NP * 8;  // the part's first query in the tile
      // P^T = exp(scale * K Q^T - lse), 0 for queries past the end.
      float p[NP][4];
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
      mma_abt<D>(p, ks + 2 * wr * LD, qs + 2 * h0 * LD, lane);
      if (qvalid >= kBlock)
        p_cols<false>(p, lse_s + h0, scale_log2, t, 0);
      else
        p_cols<true>(p, lse_s + h0, scale_log2, t, qvalid - h0);
      // dV += P^T dO: P^T (bf16) is the A operand, dO read down its query axis.
#pragma unroll
      for (int kq = 0; kq < NP / 2; ++kq) {
        uint32_t a[4];
        acc_to_a(a, p[2 * kq], p[2 * kq + 1]);
        mma_ab<D>(dv_acc, a, dos + 2 * (h0 + kq * 16) * LD, lane);
      }
      // dS^T = P^T o (V dO^T - delta), then dK += dS^T Q.
      float dst[NP][4];
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) dst[nt][0] = dst[nt][1] = dst[nt][2] = dst[nt][3] = 0.0f;
      mma_abt<D>(dst, vs + 2 * wr * LD, dos + 2 * h0 * LD, lane);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = h0 + nt * 8 + 2 * t + (e & 1);
          dst[nt][e] = p[nt][e] * (dst[nt][e] - delta_s[qi]);
        }
#pragma unroll
      for (int kq = 0; kq < NP / 2; ++kq) {
        uint32_t a[4];
        acc_to_a(a, dst[2 * kq], dst[2 * kq + 1]);
        mma_ab<D>(dk_acc, a, qs + 2 * (h0 + kq * 16) * LD, lane);
      }
    }
  }
  const int row = k0 + wr + lane / 4;
  store_rows(dk, sdk, b, h, row, nkv, dk_acc, scale, t);
  store_rows(dv, sdv, b, h, row, nkv, dv_acc, 1.0f, t);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* o, const void* lse, void* delta, void* dq, int batch,
                      int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
                      Strides sdo, Strides so, Strides sdq, float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlock - 1) / kBlock, batch * heads);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq),
      heads, nq, nkv, sq, sk, sv, sdo, so, sdq, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int batch,
                       int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
                       Strides sdo, Strides sdk, Strides sdv, float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nkv + kBlock - 1) / kBlock, batch * heads);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads,
      nq, nkv, sq, sk, sv, sdo, sdk, sdv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success). Strides are in elements, three per operand (batch, token, head);
// the head dim of every operand has stride 1.

// dQ and delta (fp32 (B, H, Nq), written here for the dK/dV kernel).
int deco_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* o, const void* lse,
                                void* delta, void* dq, int batch, int heads, int nq,
                                int nkv, int head_dim, const long long* strides, float scale,
                                void* stream) {
  const long long* s = strides;  // q, k, v, do, o, dq
  const Strides sq{s[0], s[1], s[2]}, sk{s[3], s[4], s[5]}, sv{s[6], s[7], s[8]};
  const Strides sdo{s[9], s[10], s[11]}, so{s[12], s[13], s[14]}, sdq{s[15], s[16], s[17]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dq<32>(q, k, v, dout, o, lse, delta, dq, batch, heads, nq, nkv, sq, sk, sv, sdo, so, sdq, scale, st);
    case 64:
      return launch_dq<64>(q, k, v, dout, o, lse, delta, dq, batch, heads, nq, nkv, sq, sk, sv, sdo, so, sdq, scale, st);
    case 72:
      return launch_dq<72>(q, k, v, dout, o, lse, delta, dq, batch, heads, nq, nkv, sq, sk, sv, sdo, so, sdq, scale, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, o, lse, delta, dq, batch, heads, nq, nkv, sq, sk, sv, sdo, so, sdq, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int deco_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int batch, int heads, int nq,
                                 int nkv, int head_dim, const long long* strides,
                                 float scale, void* stream) {
  const long long* s = strides;  // q, k, v, do, dk, dv
  const Strides sq{s[0], s[1], s[2]}, sk{s[3], s[4], s[5]}, sv{s[6], s[7], s[8]};
  const Strides sdo{s[9], s[10], s[11]}, sdk{s[12], s[13], s[14]}, sdv{s[15], s[16], s[17]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, batch, heads, nq, nkv, sq, sk, sv, sdo, sdk, sdv, scale, st);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, heads, nq, nkv, sq, sk, sv, sdo, sdk, sdv, scale, st);
    case 72:
      return launch_dkv<72>(q, k, v, dout, lse, delta, dk, dv, batch, heads, nq, nkv, sq, sk, sv, sdo, sdk, sdv, scale, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, heads, nq, nkv, sq, sk, sv, sdo, sdk, sdv, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What the current device makes of one instantiation (dkv = 0: the dQ
// kernel, 1: the dK/dV kernel): registers, local bytes, static and dynamic
// shared memory, resident CTAs per SM, threads, into out[0..5].
int deco_flash_attention_bwd_info(int dkv, int head_dim, int* out) {
  switch (head_dim * 2 + (dkv != 0)) {
    case 64:
      return kernel_info(flash_bwd_dq_kernel<32>, kThreads, dq_smem_bytes<32>(), out);
    case 65:
      return kernel_info(flash_bwd_dkv_kernel<32>, kThreads, dkv_smem_bytes<32>(), out);
    case 128:
      return kernel_info(flash_bwd_dq_kernel<64>, kThreads, dq_smem_bytes<64>(), out);
    case 129:
      return kernel_info(flash_bwd_dkv_kernel<64>, kThreads, dkv_smem_bytes<64>(), out);
    case 144:
      return kernel_info(flash_bwd_dq_kernel<72>, kThreads, dq_smem_bytes<72>(), out);
    case 145:
      return kernel_info(flash_bwd_dkv_kernel<72>, kThreads, dkv_smem_bytes<72>(), out);
    case 256:
      return kernel_info(flash_bwd_dq_kernel<128>, kThreads, dq_smem_bytes<128>(), out);
    case 257:
      return kernel_info(flash_bwd_dkv_kernel<128>, kThreads, dkv_smem_bytes<128>(), out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* deco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
