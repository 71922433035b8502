// Device helpers shared by the flash-attention forward and backward for
// Hopper (sm_90a): the tile layout in shared memory, zero-filling
// asynchronous copies, ldmatrix fragment loads, mma.sync tiles, and exp2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace deco {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;  // rows of a tile: 16 per warp of a 4-warp CTA
constexpr int kWarps = kBlock / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, n, h;  // elements; the head dim has stride 1
};

// A 64-row tile of one (tokens, D) operand in shared memory.
template <int D>
struct Tile {
  static constexpr int N8 = D / 8;             // 16-byte chunks in a row; n8 tiles over D
  static constexpr int K16 = D / 16;           // k16 steps over the head dim ...
  static constexpr bool K8 = D % 16 != 0;      // ... and a last k8 step
  static constexpr int LD = 8 * (N8 | 1);      // row stride in bf16: an odd number of chunks
  static constexpr int kBytes = kBlock * LD * 2;
  static_assert(D % 8 == 0, "rows are copied in 16-byte chunks");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four (or two) 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Each lane's element offset into a tile for the two ldmatrix patterns:
// - `a`: rows lane % 16, columns (lane / 16) * 8. Gives the A fragment of
//   16 rows x 16 columns (x2: 16 rows x 8 columns) and, with .trans, the B
//   fragments of a k16 x n16 block stored k-major (two n8 tiles: b[0], b[1]
//   and b[2], b[3]; x2: one n8 tile).
// - `b`: rows lane % 8 + (lane / 16) * 8, columns ((lane / 8) % 2) * 8.
//   Gives the B fragments of an n16 x k16 block stored n-major (two n8
//   tiles: b[0], b[1] and b[2], b[3]).
template <int LD>
__device__ __forceinline__ int lane_off_a(int lane) { return (lane % 16) * LD + (lane / 16) * 8; }
template <int LD>
__device__ __forceinline__ int lane_off_b(int lane) {
  return (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
}

// 2^x on the special-function unit; subnormal results flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile (A row-major 16x16, B column-major 16x8) ...
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ... and for one 16x8x8 tile.
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// The A fragment of fp32 accumulator tiles x[j], x[j + 1] (16 rows x 16
// columns of a product), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x0)[4],
                                         const float (&x1)[4]) {
  a[0] = pack_bf16x2(x0[0], x0[1]);
  a[1] = pack_bf16x2(x0[2], x0[3]);
  a[2] = pack_bf16x2(x1[0], x1[1]);
  a[3] = pack_bf16x2(x1[2], x1[3]);
}

// Rows [row0, row0 + ROWS) of a (tokens, D) plane into the tile at `dst`
// (row stride Tile<D>::LD), in flight until the caller's cp_async_wait;
// consecutive threads of the THREADS copying take consecutive 16-byte
// chunks, so a warp reads whole rows. Rows at or past `valid` are
// zero-filled, so padded tokens add exact zeros, never NaNs.
template <int D, int ROWS = kBlock, int THREADS = kThreads>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* base, long long stride,
                                          int row0, int valid) {
  using T = Tile<D>;
  constexpr int kChunks = ROWS * T::N8;
#pragma unroll
  for (int i = 0; i < (kChunks + THREADS - 1) / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (kChunks % THREADS == 0 || c < kChunks) {
      const int r = c / T::N8, ch = c % T::N8;
      const bool ok = row0 + r < valid;
      cp_async16(dst + 2 * (r * T::LD + ch * 8), base + (ok ? (row0 + r) * stride + ch * 8 : 0),
                 ok);
    }
  }
}

}  // namespace deco
