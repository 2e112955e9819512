// Polyphase rational resampler for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/resample_kernel.py:resample_mac.  Per channel the result equals
// ops/resample.resample_poly(x, up, down, h, zero_phase, history): output
// j = sum_k h[p + up*k] * raw[m - k] with j*down + delay = m*up + p, the
// history (or zeros) before x and zeros past it (resample_device.cuh).
//
// Design.  The TPU kernel turns the resampler into one dense matmul per
// tile of output cycles (a window of R*down raw samples times a static
// (R*down, up) phase matrix), because its matrix unit wants dense
// operands and Mosaic cannot reshape 160 lanes into 128; that costs
// about R*down/nk = 7x the multiply-adds at 160/147.  Here the polyphase
// MAC itself runs: one CTA per (tile of kTile outputs, channel) stages the
// (up, nk) phase bank (13 KB at 160/147) and its raw window in shared
// memory, and each thread takes neighbouring outputs, nk fmaf each (21 at
// 160/147, 22 at 147/160).
//
// What bounds it on an H100: at the headline (64 channels, 441000 ->
// 480000 samples) it moves about 113 MB in and 123 MB out, about 0.07 ms
// at 3.35 TB/s, and does about 1.3 GFLOP of fmaf; each fmaf reads two
// shared-memory words (tap and window), so shared-memory bandwidth and
// the bank staging per CTA bound it, not device memory.  Register tiling
// of several outputs per thread is later work.

#include <cuda_runtime.h>

#include "resample_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
resample_mac_kernel(const float* __restrict__ x, int x_ld,
                    const float* __restrict__ hist, int hn,
                    float* __restrict__ y, const float* __restrict__ bank,
                    asp::ResGeo g, int n, int nout) {
  extern __shared__ float4 smem4[];
  float* bank_s = reinterpret_cast<float*>(smem4);  // up * nk
  float* win_s = bank_s + g.up * g.nk;              // the tile's raw window
  const int c = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  asp::res_load_bank(bank_s, bank, g);
  const asp::RawSrc src{hist ? hist + static_cast<size_t>(c) * hn : nullptr, hn,
                        x + static_cast<size_t>(c) * x_ld, n};
  float* yc = y + static_cast<size_t>(c) * nout + j0;
  asp::res_range(g, bank_s, win_s, src, j0, min(kTile, nout - j0), 0, nout,
                 [yc](int i, float v) { yc[i] = v; });
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_resample_mac(const float* x, int x_ld, const float* hist, int hn, float* y,
                     const float* bank, int up, int down, int nk, int delay,
                     int channels, int n, int nout, int smem_bytes, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(resample_mac_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const asp::ResGeo g{up, down, nk, delay};
  const dim3 grid((nout + kTile - 1) / kTile, channels);
  resample_mac_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, x_ld, hist, hn, y, bank, g, n, nout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
