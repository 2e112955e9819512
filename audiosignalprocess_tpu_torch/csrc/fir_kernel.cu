// Direct-form FIR with history for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel kernels/fir_kernel.py:fir_mac.
// Per channel y[i] = sum_t h[t] x[i-t], output length == input length,
// with the T-1 samples before x taken from `hist` (zeros when null).
//
// Design.  One CTA per (tile of kTile outputs, channel).  The CTA stages
// the reversed taps and its window (the tile plus the T-1 samples of
// halo before it, from the history where the tile starts the stream) in
// shared memory, and each thread accumulates outputs in float32 with
// fmaf, taps in order.  The TPU kernel's double-buffered DMA of the
// window becomes a plain cooperative load: blocks run concurrently, so
// the loads of some CTAs overlap the MACs of others.
//
// What bounds it on an H100: at the envelope's shape (129 taps, 64
// channels x 480000 samples) it is about 8 GFLOP of fmaf against 246 MB
// of device memory traffic: about 32 flops per byte, so the shared-memory
// reads of the MAC loop (one window read per fmaf) bound it, not device
// memory.  Register tiling of several outputs per thread is later work.

#include <cuda_runtime.h>

#include "fir_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
fir_mac_kernel(const float* __restrict__ x, int x_ld,
               const float* __restrict__ hist, float* __restrict__ y,
               const float* __restrict__ taps_rev, int n, int taps) {
  extern __shared__ float4 smem4[];
  float* hr = reinterpret_cast<float*>(smem4);  // taps
  float* win = hr + taps;                       // kTile + taps - 1
  const int c = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const asp::HistSrc raw{hist ? hist + static_cast<size_t>(c) * (taps - 1) : nullptr,
                         x + static_cast<size_t>(c) * x_ld, taps - 1, n};
  for (int j = threadIdx.x; j < taps; j += blockDim.x) hr[j] = taps_rev[j];
  for (int i = threadIdx.x; i < kTile + taps - 1; i += blockDim.x) win[i] = raw(t0 + i);
  __syncthreads();
  const int count = min(kTile, n - t0);
  asp::mac_tile(win, hr, taps, count, 1.0f, y + static_cast<size_t>(c) * n + t0);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_fir_mac(const float* x, int x_ld, const float* hist, float* y,
                const float* taps_rev, int channels, int n, int taps,
                int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fir_mac_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, channels);
  fir_mac_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, x_ld, hist, y, taps_rev, n, taps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
