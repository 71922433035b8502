// Fused frequency-weighted MSE for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel `_freq_mse_kernel` (deco_tpu/ops/block_dct.py:175,
// launched from `frequency_weighted_mse_pallas` :216): for an NHWC pixel
// difference `diff` (B, H, W, 3), H and W multiples of 8,
//   loss = sum over 8x8 blocks and channels of w[c] o (C Y_c C^T)^2 / (B*H*W*3)
// where Y = YCbCr(diff) (JPEG matrix), C is the orthonormal 8x8 DCT-II
// matrix and w the (3, 8, 8) frequency weights.
//
// Bound on an H100 SXM at the training shape (batch 32, 256 px): the kernel
// must read diff once, 25.2 MB, 7.5 us at 3.35 TB/s; its ~0.26 GFLOP of fp32
// arithmetic takes 3.9 us at 67 TFLOP/s. It is memory-bound, so the design
// keeps enough bytes in flight to stream diff at the memory's rate while
// the DCTs run, and spends no second launch on the reduction.
//
// Design:
// - the work unit is one strip of 8 rows by 32 pixels (four 8x8 blocks,
//   8 x 384 bytes), and one warp does a unit at a time; a persistent grid
//   of 4-warp CTAs, sized to fill the card, gives every warp the same
//   number of units (walked with a stride of the warps in the grid);
// - each warp streams its units through a two-slot ring in shared memory:
//   the 16-byte cp.async.cg copies of unit n + 1 (whole rows, coalesced) are
//   in flight while unit n is transformed, and blocks past W are zero-filled;
// - lane (block b, row i) takes its row of the block, converts it to
//   YCbCr and does the row DCT Z = Y C^T in registers, with C's entries as
//   constant operands; Z goes through shared memory transposed, and the
//   same lane then takes column i of Z: F = C Z, squared and weighted by
//   the w[c][u][i] it holds in registers. Each 8-point DCT splits into its
//   even and odd halves (C[v][7-j] = (-1)^v C[v][j]): 40 operations, not 64;
// - every lane sums into one fp32 register; a CTA sums its warps in a fixed
//   order and writes one partial; the last CTA to finish (a ticket counter
//   in device memory, which it resets to 0) sums the partials in a fixed
//   order and divides. No atomic adds of values: the loss is bit-identical
//   from run to run. One launch; the ticket is the caller's, one per
//   device, and calls on one device must not run concurrently.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnitPx = 32;            // pixels a unit spans: four 8x8 blocks
constexpr int kRowWords = 3 * kUnitPx;  // floats in one row of a unit
constexpr int kRowStride = kRowWords + 4;  // padded: rows i land in distinct banks
constexpr int kSlotWords = 8 * kRowStride;
constexpr int kZv = 12;                 // Z column stride: 8 rows + 4, bank-distinct
constexpr int kZc = 8 * kZv;
constexpr int kZb = 3 * kZc + 8;        // per block: lanes of a warp on distinct banks
constexpr int kSlots = 2;               // units in a warp's ring: kSlots - 1 in flight
constexpr int kWarpWords = kSlots * kSlotWords + 4 * kZb;
constexpr int kSmemBytes = kWarps * kWarpWords * 4;

// The tables every lane reads at the same index: constant operands.
struct Consts {
  float c[64];     // DCT-II matrix, row-major C[u][i]
  float ycc[9];    // RGB -> YCbCr, row-major M[k][c]
};

// out[v] = sum_j x[j] C[v][j], by the even/odd split of the DCT-II.
__device__ __forceinline__ void dct8(const float (&x)[8], float (&out)[8], const Consts& k) {
  float a[4], d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = x[j] + x[7 - j];
    d[j] = x[j] - x[7 - j];
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float s = (v % 2 == 0 ? a[0] : d[0]) * k.c[v * 8];
#pragma unroll
    for (int j = 1; j < 4; ++j) s = fmaf(v % 2 == 0 ? a[j] : d[j], k.c[v * 8 + j], s);
    out[v] = s;
  }
}

// Sum over the CTA's threads in a fixed order: warp trees, then warp 0.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  x = threadIdx.x < kWarps ? scratch[threadIdx.x] : 0.0f;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  __syncthreads();  // scratch may be reused
  return x;         // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
    freq_mse_kernel(const float* __restrict__ diff, const float* __restrict__ freq_w,
                    float* __restrict__ partial, unsigned int* __restrict__ ticket,
                    float* __restrict__ out, int strips, int width, int units_per_strip,
                    float count, Consts k) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float scratch[kWarps];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int blk = lane / 8, i = lane % 8;  // this lane's block in the unit and row (then column)
  float* slots = smem + warp * kWarpWords;
  float* zs = slots + kSlots * kSlotWords;
  const uint32_t slots_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(slots));

  const int units = strips * units_per_strip;
  const int nwarps = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  const long long row_floats = 3LL * width;
  // diff is read once: its lines go first when L2 needs room, so they
  // displace one another rather than lines that other kernels left dirty
  // (whose write-back would double the traffic) or will read again.
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));

  // Unit n's 8 x 96 floats into slot n % kSlots: chunk f = 32 q + lane of the
  // unit is row f / 24, 16-byte chunk f % 24; chunks past W are zeros.
  auto copy_unit = [&](int unit, int n) {
    if (unit < units) {
      const int strip = unit / units_per_strip, col0 = (unit % units_per_strip) * kUnitPx;
      const int valid = min(3 * (width - col0), kRowWords) / 4;  // chunks in the image
      const float* src = diff + static_cast<long long>(strip) * 8 * row_floats + 3 * col0;
      const uint32_t dst = slots_u32 + 4 * (n % kSlots) * kSlotWords;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const int f = 32 * q + lane, r = f / 24, ch = f % 24;
        const bool ok = ch < valid;
        asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
                         dst + 4 * (r * kRowStride + 4 * ch)),
                     "l"(src + (ok ? r * row_floats + 4 * ch : 0)), "r"(ok ? 16 : 0),
                     "l"(evict_first));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float sum = 0.0f;
#pragma unroll
  for (int n = 0; n < kSlots - 1; ++n) copy_unit(first + n * nwarps, n);
  // w[c][u][i], this lane's column of the weights (device memory: the lanes
  // read 8 different addresses, which the constant bank would serialise)
  float w[3][8];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int u = 0; u < 8; ++u) w[c][u] = __ldg(freq_w + c * 64 + u * 8 + i);
  for (int n = 0, unit = first; unit < units; ++n, unit += nwarps) {
    // into the slot of unit n - 1, which the last pass read into registers
    copy_unit(unit + (kSlots - 1) * nwarps, n + kSlots - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSlots - 1) : "memory");
    __syncwarp();
    // Row i of block blk: 8 pixels x RGB, as six float4.
    const float* row = slots + (n % kSlots) * kSlotWords + i * kRowStride + blk * 24;
    float px[24];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 x = reinterpret_cast<const float4*>(row)[q];
      px[4 * q] = x.x;
      px[4 * q + 1] = x.y;
      px[4 * q + 2] = x.z;
      px[4 * q + 3] = x.w;
    }
    // YCbCr, the row DCT, and Z row i into shared memory (Z[blk][c][v][i]).
    float* zb = zs + blk * kZb;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float y[8], z[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = k.ycc[3 * c] * px[3 * j] + k.ycc[3 * c + 1] * px[3 * j + 1] +
               k.ycc[3 * c + 2] * px[3 * j + 2];
      dct8(y, z, k);
#pragma unroll
      for (int v = 0; v < 8; ++v) zb[c * kZc + v * kZv + i] = z[v];
    }
    __syncwarp();
    // Column i of Z: F[c][u][i] = sum_r C[u][r] Z[r][i].
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4* col = reinterpret_cast<const float4*>(zb + c * kZc + i * kZv);
      const float4 lo = col[0], hi = col[1];
      const float z[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float f[8];
      dct8(z, f, k);
#pragma unroll
      for (int u = 0; u < 8; ++u) sum = fmaf(w[c][u] * f[u], f[u], sum);
    }
    __syncwarp();  // Z is rewritten by the next unit
  }

  sum = block_sum(sum, scratch);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = sum;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last CTA: thread t sums partials t, t + 128, ... in order (read
  // from L2, past this SM's L1), then the CTA's fixed tree; the result does
  // not depend on which CTA came last.
  __threadfence();
  float total = 0.0f;
  for (int p = threadIdx.x; p < gridDim.x; p += kThreads) total += __ldcg(partial + p);
  total = block_sum(total, scratch);
  if (threadIdx.x == 0) {
    out[0] = total / count;
    *ticket = 0u;  // ready for the next call
  }
}

// CTAs of the persistent grid: as many as fit on the card at once (asked of
// the runtime once per device), cut so that every warp walks the same
// number of units.
int grid_size(int units) {
  static int resident[64];  // CTAs that fit on each device at once
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(freq_mse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, freq_mse_kernel, kThreads,
                                                      kSmemBytes) != cudaSuccess ||
        per_sm == 0)
      return 0;
    resident[dev] = sms * per_sm;
  }
  const int warps = resident[dev] * kWarps;
  const int per_warp = (units + warps - 1) / warps;
  const int need = (units + per_warp - 1) / per_warp;  // warps
  return (need + kWarps - 1) / kWarps;
}

int units_of(int batch, int height, int width) {
  return batch * (height / 8) * ((width + kUnitPx - 1) / kUnitPx);
}

}  // namespace

extern "C" {

// Number of partial sums (CTAs of the grid) for a (batch, height, width)
// input on the current device; 0 if the device cannot be queried.
int deco_freq_mse_partials(int batch, int height, int width) {
  return grid_size(units_of(batch, height, width));
}

// Writes the loss to out[0]. `freq_w` is the (3, 8, 8) fp32 weights in
// device memory; `partial` holds deco_freq_mse_partials(...) floats of
// scratch; `ticket` is one unsigned int of device memory that is 0 before
// the call and is 0 again after it. `cmat` (8x8) and `ycc` (3x3) are host
// float arrays, passed to the kernel by value. `diff` must be 16-byte
// aligned. Launches on `stream`; returns cudaGetLastError() (0 on success).
int deco_freq_mse(const void* diff, const void* freq_w, void* partial, void* ticket,
                  void* out, int batch, int height, int width, const float* cmat,
                  const float* ycc, void* stream) {
  if (height % 8 || width % 8 || batch <= 0 || height <= 0 || width <= 0 ||
      reinterpret_cast<uintptr_t>(diff) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts k;
  for (int i = 0; i < 64; ++i) k.c[i] = cmat[i];
  for (int i = 0; i < 9; ++i) k.ycc[i] = ycc[i];
  const int units = units_of(batch, height, width);
  const int grid = grid_size(units);
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  const float count = static_cast<float>(batch) * height * width * 3;
  freq_mse_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(diff), static_cast<const float*>(freq_w),
      static_cast<float*>(partial), static_cast<unsigned int*>(ticket), static_cast<float*>(out), batch * (height / 8),
      width, (width + kUnitPx - 1) / kUnitPx, count, k);
  return static_cast<int>(cudaGetLastError());
}

// What the current device makes of the kernel: registers, local bytes,
// static and dynamic shared memory, resident CTAs per SM, threads.
int deco_freq_mse_info(int* out) {
  return static_cast<int>(deco::kernel_info(freq_mse_kernel, kThreads, kSmemBytes, out));
}

const char* deco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
