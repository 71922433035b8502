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
// (flash_attention_bwd.cu). It adds 4*B*H*Nq bytes to the output, 2.7% at
// D = 72; the instantiation without it (sampling) is unchanged.
//
// Layout: q is (B, Nq, H, D), k and v are (B, Nkv, H, D), o is (B, Nq, H, D).
// The kernel reads each operand in place through its (batch, token, head)
// strides, with the head dim contiguous, so no fold/unfold transposes run
// around it. Nq and Nkv are arbitrary: keys >= Nkv get -inf before the
// softmax and rows >= Nq are never stored.
//
// Numerics follow the TPU kernel: QK^T and PV accumulate in fp32 on the
// tensor cores; the running max, running sum and the accumulator are fp32;
// P is rounded to bf16 before PV (`p.astype(v.dtype)`, :97); O = acc / l is
// rounded to bf16 once at the end.
//
// Bound on an H100 SXM at the main-path shape (DeCo-XL/16, 256 px: N = 256,
// H = 16, D = 72, B*H = 256 with CFG at batch 8): the function moves
// 4*BH*N*D*2 bytes = 37.7 MB (q, k, v read once, o written once), 11.3 us
// at 3.35 TB/s, and does 4*BH*Nq*Nkv*D = 4.8 GFLOP, 4.9 us at 989 TFLOP/s.
// At about 128 FLOP per byte, under the card's ~295, it is memory-bound.
//
// Design (simple first; speed is later work):
// - one CTA of 4 warps per (batch*head, 64-row query tile); each warp owns
//   16 query rows and keeps its Q fragments in registers for the whole run;
// - K and V stream through shared memory in 64-key tiles; V is stored
//   transposed so both products read their B operand as 32-bit pairs;
// - the products are `mma.sync.m16n8k16` bf16 -> fp32; D is a template
//   parameter padded with zeros to a multiple of 16 in shared memory only
//   (72 -> 80), never in device memory, so the kernel reads no extra bytes;
// - the online softmax runs on the accumulator fragments, and P goes from
//   the QK^T accumulators straight into the A operand of PV in registers.
// Against the bound: each byte of q and o crosses device memory once; k and
// v are read once per query tile (4 times at N = 256), which the 50 MB L2
// absorbs. Nothing is double-buffered yet, so loads and MMAs do not overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per CTA, 16 per warp
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 of row padding: fragment loads hit distinct banks

struct Strides {
  long long b, n, h;  // elements; the head dim has stride 1
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <int D, bool LSE>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int heads, int nq, int nkv, Strides sq, Strides sk,
                     Strides sv, Strides so, float scale) {
  constexpr int DP = (D + 15) / 16 * 16;  // head dim padded for k16 MMAs
  constexpr int KD = DP / 16;             // k16 steps over the head dim
  constexpr int ND = DP / 8;              // n8 tiles over the head dim
  constexpr int NK = kBlockK / 8;         // n8 tiles over a key tile
  constexpr int KK = kBlockK / 16;        // k16 steps over a key tile
  constexpr int CH = D / 8;               // 16-byte chunks in one row
  constexpr int LDK = DP + kPad;
  constexpr int LDV = kBlockK + kPad;
  static_assert(D % 8 == 0, "rows are read in 16-byte chunks");

  // The query tile passes through `ks` first; then `ks` holds K tiles.
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LDK];
  __shared__ __align__(16) __nv_bfloat16 vt[DP * LDV];  // V tile, transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // MMA fragment row group and column
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

  // Zero the padded head-dim columns once; tile loads never write them.
  if constexpr (DP > D) {
    for (int i = tid; i < kBlockK * (DP - D); i += kThreads)
      ks[(i / (DP - D)) * LDK + D + i % (DP - D)] = zero;
    for (int i = tid; i < (DP - D) * LDV; i += kThreads) vt[D * LDV + i] = zero;
  }

  // Rows [row0, row0 + 64) of a (tokens, D) plane into `ks`; rows past
  // `valid` are zero, so padded keys add exact zeros and never NaNs.
  auto load_rows = [&](const __nv_bfloat16* base, long long stride, int row0,
                       int valid) {
    for (int c = tid; c < kBlockK * CH; c += kThreads) {
      const int r = c / CH, ch = c % CH;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < valid)
        val = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride + ch * 8);
      *reinterpret_cast<uint4*>(&ks[r * LDK + ch * 8]) = val;
    }
  };

  load_rows(qp, sq.n, q0, nq);
  __syncthreads();
  uint32_t qf[KD][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = ld_pair(&ks[qr * LDK + c]);
    qf[kk][1] = ld_pair(&ks[(qr + 8) * LDK + c]);
    qf[kk][2] = ld_pair(&ks[qr * LDK + c + 8]);
    qf[kk][3] = ld_pair(&ks[(qr + 8) * LDK + c + 8]);
  }

  // Row statistics for rows g and g + 8 of this warp's 16; `l` holds this
  // thread's partial sum over its columns until the end.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float acc[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  for (int k0 = 0; k0 < nkv; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows(kp, sk.n, k0, nkv);
    for (int c = tid; c < kBlockK * CH; c += kThreads) {
      const int r = c / CH, ch = c % CH;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < nkv)
        val = *reinterpret_cast<const uint4*>(vp + (k0 + r) * sv.n + ch * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(ch * 8 + i) * LDV + r] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* krow = &ks[(nt * 8 + g) * LDK + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_16816(s[nt], qf[kk], ld_pair(krow + kk * 16), ld_pair(krow + kk * 16 + 8));
    }

    // Online softmax. Every tile holds at least one valid key, so the new
    // max is finite and exp(-inf - m) = 0 clears the first correction.
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = key < nkv ? s[nt][e] * scale : -INFINITY;
        s[nt][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      corr[r] = expf(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rsum[r];
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V: the S accumulators of key tiles 2kk and 2kk+1 are exactly
    // the A fragment of the k16 step kk, rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t a[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        const __nv_bfloat16* vrow = &vt[(dt * 8 + g) * LDV + kk * 16 + 2 * t];
        mma_16816(acc[dt], a, ld_pair(vrow), ld_pair(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + 8 * r;
    if (row >= nq) continue;
    if constexpr (LSE) {
      if (t == 0) lse[static_cast<long long>(blockIdx.y) * nq + row] = m_run[r] + logf(l_run[r]);
    }
    __nv_bfloat16* orow = o + b * so.b + row * so.n + h * so.h;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[dt][2 * r] / l_run[r], acc[dt][2 * r + 1] / l_run[r]);
    }
  }
}

template <int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int heads, int nq, int nkv,
                   Strides sq, Strides sk, Strides sv, Strides so, float scale,
                   cudaStream_t stream) {
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<D, LSE><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      heads, nq, nkv, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int batch, int heads, int nq, int nkv, int head_dim, Strides sq,
             Strides sk, Strides sv, Strides so, float scale, cudaStream_t st) {
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

const char* deco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
