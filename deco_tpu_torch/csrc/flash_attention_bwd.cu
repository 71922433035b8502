// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV, bf16.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (deco_tpu/ops/flash_attention.py:344,
// launched from `_flash_bwd_pallas` :549) with its streaming twin
// `_bwd_dq_kernel_stream` (:421), and `_bwd_dkv_kernel` (:379, launched at
// :562) with `_bwd_dkv_kernel_stream` (:454). One kernel covers each pair,
// because the streamed operands always pass through shared memory in tiles.
//
// Both recompute P = exp(scale * Q K^T - lse) from the forward's fp32 lse
// (flash_attention_fwd.cu, LSE instantiation) and take delta = rowsum(dO * O),
// fp32, computed outside the kernels as in `_flash_core_bwd` (:623):
//   dQ = scale * [P o (dO V^T - delta)] K                 (dq kernel)
//   dV = P^T dO,  dK = scale * [P o (dO V^T - delta)]^T Q   (dkv kernel)
// Rounding follows the TPU kernels: dS is rounded to bf16 before dS K and
// dS^T Q (:368, :408), P before P^T dO (:401); the accumulators are fp32 and
// dQ, dK are scaled at the end (:376, :417), then rounded to bf16.
//
// Layout and conventions are the forward's: q, do, dq are (B, Nq, H, D),
// k, v, dk, dv are (B, Nkv, H, D), each read or written in place through its
// (batch, token, head) strides with the head dim contiguous; lse and delta
// are fp32 (B, H, Nq) contiguous; D in {64, 72, 128} is padded with zeros to
// a multiple of 16 in shared memory only; ragged Nq, Nkv and Nq != Nkv are
// masked in the kernel (P = 0 for keys >= Nkv and for queries >= Nq).
//
// Bound on an H100 SXM at the training shape (DeCo-XL/16, 256 px, batch 32:
// B*H = 512, N = 256, D = 72; one bf16 operand is 18.9 MB): dQ moves
// q, k, v, do, dq + lse, delta = 95.4 MB, 28.5 us at 3.35 TB/s, and does
// 6*BH*N^2*D = 14.5 GFLOP, 14.7 us at 989 TFLOP/s; dK/dV moves 114.3 MB,
// 34.1 us, and does 19.3 GFLOP, 19.5 us. Both are memory-bound.
//
// Design (simple first; speed is later work):
// - dQ: one CTA of 4 warps per (batch*head, 64-query tile), as the Pallas
//   grid (bh, q blocks); each warp keeps its 16 rows of Q and dO as MMA
//   fragments in registers and streams 64-key tiles of K and V through
//   shared memory. dK/dV: one CTA per (batch*head, 64-key tile); each warp
//   keeps 16 rows of K and V in registers and streams 64-query tiles of Q,
//   dO, lse and delta. Each output row is owned by one CTA, so no atomics
//   are needed and the result is deterministic.
// - The products are `mma.sync.m16n8k16` bf16 -> fp32. Products whose B
//   operand runs down a token column (dS K, P^T dO, dS^T Q) read it as two
//   scalar bf16 loads per register; nothing is stored transposed.
// - Nothing is double-buffered yet, so loads and MMAs do not overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // rows per CTA and per streamed tile, 16 per warp
constexpr int kWarps = kBlock / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 of row padding: fragment loads hit distinct banks

struct Strides {
  long long b, n, h;  // elements; the head dim has stride 1
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] and p[ld] packed into one register: a B fragment read down a column.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int ld) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[ld];
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile (A row-major 16x16, B column-major 16x8).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 64) of a (tokens, D) plane into `dst` (row stride LD);
// rows past `valid` are zero, so padded tokens add exact zeros, never NaNs.
template <int D, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long stride, int row0, int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks in one row
  for (int c = threadIdx.x; c < kBlock * CH; c += kThreads) {
    const int r = c / CH, ch = c % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride + ch * 8);
    *reinterpret_cast<uint4*>(&dst[r * LD + ch * 8]) = val;
  }
}

// Zero the padded head-dim columns [D, DP) of a 64-row tile once.
template <int D, int DP, int LD>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* tile) {
  if constexpr (DP > D) {
    for (int i = threadIdx.x; i < kBlock * (DP - D); i += kThreads)
      tile[(i / (DP - D)) * LD + D + i % (DP - D)] = __float2bfloat16(0.0f);
  }
}

// The A fragments (16 rows x DP) of rows [row, row + 8) and [row + 8, row + 16).
template <int KD, int LD>
__device__ __forceinline__ void load_a(uint32_t (&f)[KD][4], const __nv_bfloat16* tile,
                                       int row, int t) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = ld_pair(&tile[row * LD + c]);
    f[kk][1] = ld_pair(&tile[(row + 8) * LD + c]);
    f[kk][2] = ld_pair(&tile[row * LD + c + 8]);
    f[kk][3] = ld_pair(&tile[(row + 8) * LD + c + 8]);
  }
}

// s = A B^T for a warp's 16 rows against the 64 rows of `tile` (contracting D).
template <int KD, int NK, int LD>
__device__ __forceinline__ void rows_times_tile(float (&s)[NK][4], const uint32_t (&a)[KD][4],
                                                const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NK; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const __nv_bfloat16* row = &tile[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      mma_16816(s[nt], a[kk], ld_pair(row + kk * 16), ld_pair(row + kk * 16 + 8));
  }
}

// acc += X tile, where X (16 x 64, fp32 accumulators rounded to bf16) is the
// A operand and the 64 x DP `tile` (contracting its 64 rows) is B.
template <int NK, int ND, int LD>
__device__ __forceinline__ void acc_times_tile(float (&acc)[ND][4], const float (&x)[NK][4],
                                               const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    const uint32_t a[4] = {
        pack_bf16x2(x[2 * kk][0], x[2 * kk][1]),
        pack_bf16x2(x[2 * kk][2], x[2 * kk][3]),
        pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]),
    };
    const __nv_bfloat16* col = &tile[(kk * 16 + 2 * t) * LD + g];
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      mma_16816(acc[dt], a, ld_col_pair(col + dt * 8, LD), ld_col_pair(col + 8 * LD + dt * 8, LD));
  }
}

// Rows [row, row + 8) and [row + 8, row + 16) of acc * mul, as bf16, for rows < valid.
template <int D, int ND>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, Strides s, int b, int h,
                                           int row, int valid, const float (&acc)[ND][4],
                                           float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row + 8 * r;
    if (n >= valid) continue;
    __nv_bfloat16* out = base + b * s.b + n * s.n + h * s.h;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int heads, int nq, int nkv,
                        Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                        float scale) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int KD = DP / 16, ND = DP / 8, NK = kBlock / 8;
  constexpr int LD = DP + kPad;
  static_assert(D % 8 == 0, "rows are read in 16-byte chunks");

  // The query tile passes through `ks` and the dO tile through `vs` first.
  __shared__ __align__(16) __nv_bfloat16 ks[kBlock * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlock * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlock;
  const int qr = warp * 16 + g;  // this thread's first row in the tile

  zero_pad<D, DP, LD>(ks);
  zero_pad<D, DP, LD>(vs);
  load_rows<D, LD>(ks, q + b * sq.b + h * sq.h, sq.n, q0, nq);
  load_rows<D, LD>(vs, dout + b * sdo.b + h * sdo.h, sdo.n, q0, nq);
  __syncthreads();
  uint32_t qf[KD][4], df[KD][4];
  load_a<KD, LD>(qf, ks, qr, t);
  load_a<KD, LD>(df, vs, qr, t);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + qr + 8 * r;
    const long long i = static_cast<long long>(blockIdx.y) * nq + n;
    row_lse[r] = n < nq ? lse[i] : 0.0f;
    row_delta[r] = n < nq ? delta[i] : 0.0f;
  }

  float acc[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;
  for (int k0 = 0; k0 < nkv; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, LD>(ks, kp, sk.n, k0, nkv);
    load_rows<D, LD>(vs, vp, sv.n, k0, nkv);
    __syncthreads();

    float s[NK][4], dp[NK][4];
    rows_times_tile<KD, NK, LD>(s, qf, ks, g, t);   // Q K^T
    rows_times_tile<KD, NK, LD>(dp, df, vs, g, t);  // dO V^T
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float p = key < nkv ? expf(s[nt][e] * scale - row_lse[e >> 1]) : 0.0f;
        s[nt][e] = p * (dp[nt][e] - row_delta[e >> 1]);  // dS
      }
    acc_times_tile<NK, ND, LD>(acc, s, ks, g, t);  // += dS K
  }
  store_rows<D, ND>(dq, sdq, b, h, q0 + qr, nq, acc, scale, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, float scale) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int KD = DP / 16, ND = DP / 8, NQ = kBlock / 8;
  constexpr int LD = DP + kPad;
  static_assert(D % 8 == 0, "rows are read in 16-byte chunks");

  // The key tile passes through `qs` and the value tile through `ds` first.
  __shared__ __align__(16) __nv_bfloat16 qs[kBlock * LD];
  __shared__ __align__(16) __nv_bfloat16 ds[kBlock * LD];
  __shared__ float lse_s[kBlock], delta_s[kBlock];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kBlock;
  const int kr = warp * 16 + g;

  zero_pad<D, DP, LD>(qs);
  zero_pad<D, DP, LD>(ds);
  load_rows<D, LD>(qs, k + b * sk.b + h * sk.h, sk.n, k0, nkv);
  load_rows<D, LD>(ds, v + b * sv.b + h * sv.h, sv.n, k0, nkv);
  __syncthreads();
  uint32_t kf[KD][4], vf[KD][4];
  load_a<KD, LD>(kf, qs, kr, t);
  load_a<KD, LD>(vf, ds, kr, t);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.0f;

  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* dop = dout + b * sdo.b + h * sdo.h;
  const float* lse_p = lse + static_cast<long long>(blockIdx.y) * nq;
  const float* delta_p = delta + static_cast<long long>(blockIdx.y) * nq;
  for (int q0 = 0; q0 < nq; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, LD>(qs, qp, sq.n, q0, nq);
    load_rows<D, LD>(ds, dop, sdo.n, q0, nq);
    for (int i = threadIdx.x; i < kBlock; i += kThreads) {
      lse_s[i] = q0 + i < nq ? lse_p[q0 + i] : 0.0f;
      delta_s[i] = q0 + i < nq ? delta_p[q0 + i] : 0.0f;
    }
    __syncthreads();

    // Transposed scores: this warp's 16 keys (rows) against 64 queries.
    float p[NQ][4], dst[NQ][4];
    rows_times_tile<KD, NQ, LD>(p, kf, qs, g, t);    // K Q^T
    rows_times_tile<KD, NQ, LD>(dst, vf, ds, g, t);  // V dO^T = dP^T
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        const float pe = q0 + qi < nq ? expf(p[nt][e] * scale - lse_s[qi]) : 0.0f;
        p[nt][e] = pe;
        dst[nt][e] = pe * (dst[nt][e] - delta_s[qi]);  // dS^T
      }
    acc_times_tile<NQ, ND, LD>(dv_acc, p, ds, g, t);    // += P^T dO
    acc_times_tile<NQ, ND, LD>(dk_acc, dst, qs, g, t);  // += dS^T Q
  }
  store_rows<D, ND>(dk, sdk, b, h, k0 + kr, nkv, dk_acc, scale, t);
  store_rows<D, ND>(dv, sdv, b, h, k0 + kr, nkv, dv_acc, 1.0f, t);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int batch,
                      int heads, int nq, int nkv, Strides sq, Strides sk, Strides sv,
                      Strides sdo, Strides sdq, float scale, cudaStream_t stream) {
  const dim3 grid((nq + kBlock - 1) / kBlock, batch * heads);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), heads, nq, nkv, sq, sk, sv, sdo, sdq, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int batch, int heads, int nq, int nkv, Strides sq, Strides sk,
                       Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
                       cudaStream_t stream) {
  const dim3 grid((nkv + kBlock - 1) / kBlock, batch * heads);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), heads, nq, nkv,
      sq, sk, sv, sdo, sdk, sdv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success). Strides are in elements, three per operand (batch, token, head);
// the head dim of every operand has stride 1.
int deco_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int batch, int heads, int nq, int nkv,
                                int head_dim, const long long* strides, float scale,
                                void* stream) {
  const long long* s = strides;  // q, k, v, do, dq
  const Strides sq{s[0], s[1], s[2]}, sk{s[3], s[4], s[5]}, sv{s[6], s[7], s[8]};
  const Strides sdo{s[9], s[10], s[11]}, sdq{s[12], s[13], s[14]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, heads, nq, nkv, sq, sk, sv, sdo, sdq, scale, st);
    case 72:
      return launch_dq<72>(q, k, v, dout, lse, delta, dq, batch, heads, nq, nkv, sq, sk, sv, sdo, sdq, scale, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, heads, nq, nkv, sq, sk, sv, sdo, sdq, scale, st);
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

const char* deco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
