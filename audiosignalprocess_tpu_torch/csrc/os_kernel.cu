// Overlap-save FIR with history for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/os_kernel.py:overlap_save_fused.  Per channel it equals the
// causal direct-form FIR of x with the T-1 samples of `hist` before it
// (zeros when null), output length == input length: block k of
// B = N - (T-1) outputs is the inverse FFT of FFT(raw[k*B, k*B + N)) times
// the tap spectrum, its first T-1 samples discarded.
//
// Design.  One CTA per (pair of blocks, channel).  The two real blocks
// ride one complex N-point transform (asp::os_block_pair), which halves
// the transforms; the CTA reads its raw span straight from device memory
// into the FFT buffer and writes its 2*B outputs once.  The TPU kernel's
// row-space layout (emission offset and block hop rounded to the row
// width) does not carry over: the block is exactly N - (T-1).
//
// What bounds it on an H100: at 64 taps, N = 1024 and 64 x 480000 samples
// it is about 32000 complex 1024-point transforms (about 6.5 GFLOP) and
// 246 MB of device memory traffic, so the radix-2 stages in shared memory
// bound it, as in chain_kernel.cu.

#include <cuda_runtime.h>

#include "fir_device.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
overlap_save_kernel(const float* __restrict__ x, int x_ld,
                    const float* __restrict__ hist, float* __restrict__ y,
                    const float2* __restrict__ hf, const float2* __restrict__ tw,
                    int n, int n_fft, int log2n, int taps, int nblk) {
  extern __shared__ float4 smem4[];
  float2* tw_s = reinterpret_cast<float2*>(smem4);  // N/2
  float2* z = tw_s + n_fft / 2;                     // N
  const int c = blockIdx.y;
  const int k = 2 * blockIdx.x;
  const bool two = k + 1 < nblk;
  const int blk = n_fft - (taps - 1);
  const float inv_n = 1.0f / static_cast<float>(n_fft);
  const asp::HistSrc raw{hist ? hist + static_cast<size_t>(c) * (taps - 1) : nullptr,
                         x + static_cast<size_t>(c) * x_ld, taps - 1, n};
  for (int i = threadIdx.x; i < n_fft / 2; i += blockDim.x) tw_s[i] = tw[i];
  __syncthreads();
  asp::os_block_pair(z, raw, k, two, blk, n_fft, log2n, hf, tw_s);
  float* yc = y + static_cast<size_t>(c) * n;
  for (int i = threadIdx.x; i < blk; i += blockDim.x) {
    const float2 v = z[taps - 1 + i];
    const int o = k * blk + i;
    if (o < n) yc[o] = v.x * inv_n;
    if (two && o + blk < n) yc[o + blk] = v.y * inv_n;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_overlap_save(const float* x, int x_ld, const float* hist, float* y,
                     const float* hf, const float* tw, int channels, int n,
                     int n_fft, int log2n, int taps, int smem_bytes, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(overlap_save_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blk = n_fft - (taps - 1);
  const int nblk = (n + blk - 1) / blk;
  const dim3 grid((nblk + 1) / 2, channels);
  overlap_save_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, x_ld, hist, y, reinterpret_cast<const float2*>(hf),
      reinterpret_cast<const float2*>(tw), n, n_fft, log2n, taps, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
