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
// arithmetic takes 3.9 us at 67 TFLOP/s. It is memory-bound.
//
// Design:
// - pass 1: one CTA of 256 threads per (8-row strip, 256-column tile). It
//   reads its 8 x 256 x 3 floats of diff exactly once, coalesced, converts
//   them to YCbCr into shared memory, and each thread then owns one (block,
//   frequency row u): it forms row u of C X for each channel in registers,
//   then row u of (C X) C^T, and sums w * F^2. The CTA reduces its threads'
//   sums in a fixed order and writes one partial.
// - pass 2: one CTA reduces the partials in a fixed order and divides.
// The TPU kernel adds every program's sum into one SMEM scalar along its
// sequential grid; CTAs run concurrently here, so the two passes replace it.
// No atomics: the loss is bit-identical from run to run. Any H and W that
// are multiples of 8 work (the last column tile of a row is masked).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 256;     // columns per CTA: 32 blocks of 8
constexpr int kThreads = 256;   // one thread per (block, frequency row)
constexpr int kReduceThreads = 1024;

struct Consts {
  float c[64];     // DCT-II matrix, row-major C[u][i]
  float ycc[9];    // RGB -> YCbCr, row-major M[k][c]
  float w[3 * 64]; // frequency weights w[ch][u][v]
};

// Sum over the block's threads in a fixed order: warp trees, then warp 0.
template <int THREADS>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = x;
  __syncthreads();
  x = 0.0f;
  if (threadIdx.x < 32) {
    x = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
    freq_mse_partial_kernel(const float* __restrict__ diff, float* __restrict__ partial,
                            int width, Consts k) {
  __shared__ float ys[3][8][kTileW + 1];  // YCbCr of the tile, channel-major
  // The matrices indexed by thread (u differs within a warp) move to shared
  // memory: the constant bank serialises differing addresses.
  __shared__ float cs[64], ws[3 * 64];
  for (int i = threadIdx.x; i < 64; i += kThreads) cs[i] = k.c[i];
  for (int i = threadIdx.x; i < 3 * 64; i += kThreads) ws[i] = k.w[i];

  const int strip = blockIdx.x;  // b * (H / 8) + block row
  const int c0 = blockIdx.y * kTileW;
  const int cols = min(kTileW, width - c0);
  const float* base = diff + (static_cast<long long>(strip) * 8 * width + c0) * 3;

  for (int i = threadIdx.x; i < 8 * cols; i += kThreads) {
    const int r = i / cols, col = i % cols;
    const float* px = base + static_cast<long long>(r) * width * 3 + col * 3;
    const float red = px[0], green = px[1], blue = px[2];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      ys[ch][r][col] = k.ycc[ch * 3] * red + k.ycc[ch * 3 + 1] * green + k.ycc[ch * 3 + 2] * blue;
  }
  __syncthreads();

  const int blk = threadIdx.x / 8, u = threadIdx.x % 8;
  float sum = 0.0f;
  if (blk * 8 < cols) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float row[8];  // row u of C X
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) a += cs[u * 8 + i] * ys[ch][i][blk * 8 + j];
        row[j] = a;
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float f = 0.0f;  // (C X C^T)[u][v]
#pragma unroll
        for (int j = 0; j < 8; ++j) f += row[j] * cs[v * 8 + j];
        sum += ws[ch * 64 + u * 8 + v] * f * f;
      }
    }
  }
  sum = block_sum<kThreads>(sum);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = sum;
}

__global__ void __launch_bounds__(kReduceThreads)
    freq_mse_reduce_kernel(const float* __restrict__ partial, int n, float count,
                           float* __restrict__ out) {
  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) sum += partial[i];
  sum = block_sum<kReduceThreads>(sum);
  if (threadIdx.x == 0) out[0] = sum / count;
}

}  // namespace

extern "C" {

// Number of partial sums (pass-1 CTAs) for a (batch, height, width) input.
int deco_freq_mse_partials(int batch, int height, int width) {
  return batch * (height / 8) * ((width + kTileW - 1) / kTileW);
}

// Writes the loss to out[0]. `partial` holds deco_freq_mse_partials(...)
// floats of scratch. `cmat` (8x8), `ycc` (3x3) and `freq_w` (3x8x8) are
// host float arrays, passed to the kernel by value. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
int deco_freq_mse(const void* diff, void* partial, void* out, int batch, int height,
                  int width, const float* cmat, const float* ycc, const float* freq_w,
                  void* stream) {
  if (height % 8 || width % 8 || batch <= 0 || height <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts k;
  for (int i = 0; i < 64; ++i) k.c[i] = cmat[i];
  for (int i = 0; i < 9; ++i) k.ycc[i] = ycc[i];
  for (int i = 0; i < 3 * 64; ++i) k.w[i] = freq_w[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch * (height / 8), (width + kTileW - 1) / kTileW);
  freq_mse_partial_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(diff),
                                                     static_cast<float*>(partial), width, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float count = static_cast<float>(batch) * height * width * 3;
  freq_mse_reduce_kernel<<<1, kReduceThreads, 0, st>>>(
      static_cast<const float*>(partial), deco_freq_mse_partials(batch, height, width),
      count, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* deco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
