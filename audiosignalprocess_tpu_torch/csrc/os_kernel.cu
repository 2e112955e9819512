// Overlap-save FIR with history for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/os_kernel.py:overlap_save_fused.  Per channel it equals the
// causal direct-form FIR of x with the T-1 samples of `hist` before it
// (zeros when null), output length == input length: block k of
// B = N - (T-1) outputs is the inverse FFT of FFT(raw[k*B, k*B + N)) times
// the tap spectrum, its first T-1 samples discarded.
//
// Design.  The body is asp::os_regs (chain_regs_device.cuh): the whole-file
// kernels' batched register Stockham round trip, with the tap product in
// the merged pass's registers (fir_middle).  Two blocks ride one complex
// transform as re/im (the taps are real); a unit is one transform, a
// (channel, pair of blocks), numbered across channels, and a CTA takes the
// units of one batch: kOsThreads threads of 16 points up to nfft 1024 (one
// transform of 1024 points a CTA, or several smaller ones), nfft/16
// threads above it (one transform), so a stream's block of 64 channels x
// 4096 samples at nfft 1024 (3 transforms a channel) is 192 CTAs on 132
// SMs.  The first pass reads the raw samples straight from device memory,
// the last pass writes y; the per-stage twiddle tables are read from
// device memory through L1, so no CTA stages anything but the exchange.
// nfft below 16: one thread a transform (R = nfft).  nfft 8192: one
// transform of 512 threads with one exchange buffer (64 KB), every pass
// holding its points across the barrier; nfft 16384 (config 4's 4096
// taps): one transform of kOsBigThreads threads of 16384 / kOsBigThreads
// points, one exchange buffer (128 KB).  The TPU kernel's row-space layout
// (emission offset and block hop rounded to the row width) does not carry
// over: the block is exactly N - (T-1).
//
// What bounds it on an H100: at 64 taps, N = 1024 and 64 x 480000 samples
// it is 16000 complex 1024-point transforms each way (about 1.6 GFLOP) and
// 246 MB of device memory traffic, about 0.07 ms at 3.35 TB/s: device
// memory and the transforms' exchanges through shared memory.

#include <cuda_runtime.h>

#include "chain_regs_device.cuh"

namespace {

constexpr int kOsThreads = 64;      // threads of a CTA up to nfft 1024 (OS_THREADS)
constexpr int kOsBigThreads = 1024;  // threads of the transform at nfft 16384

// Points a thread holds (os_geometry in kernels/os_kernel.py): nfft below
// 16, 16 up to 8192, 16384 / kOsBigThreads past it.
constexpr int os_points(int nfft) {
  return nfft < 16 ? nfft : nfft > 8192 ? nfft / kOsBigThreads : 16;
}

constexpr int os_threads(int nfft) {
  return nfft / os_points(nfft) > kOsThreads ? nfft / os_points(nfft) : kOsThreads;
}

constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

template <int R, int RS, int T, bool kSolo>
__global__ void __launch_bounds__(T, T < 512 ? 512 / T : 1)
overlap_save_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                    float* __restrict__ y, const float2* __restrict__ hf,
                    const float2* __restrict__ twf, const float2* __restrict__ twi,
                    asp::OsGeo g, int log2n) {
  extern __shared__ float4 smem[];
  asp::os_regs<R, RS, T, (T * R > 4096), kSolo>(g, log2n, reinterpret_cast<float*>(smem), x,
                                                hist, y, hf, twf, twi);
}

using Kernel = void (*)(const float*, const float*, float*, const float2*, const float2*,
                        const float2*, asp::OsGeo, int);

// The instantiation at nfft N: one pass each way below 32 points, else
// passes of R points a group and the merged pass of 2^(log2 N mod 4)
// points (2 where that is 0), as regs_pass_plan plans them; a batch of one
// transform where N = T R.
template <int N>
Kernel os_kernel_at() {
  constexpr int R = os_points(N), T = os_threads(N);
  constexpr int rs = log2i(N) % 4;
  constexpr int RS = N <= 16 ? N : rs == 2 ? 4 : rs == 3 ? 8 : 2;
  return overlap_save_kernel<R, RS, T, N == T * R>;
}

Kernel os_kernel_for(int nfft) {
  switch (nfft) {
    case 2: return os_kernel_at<2>();
    case 4: return os_kernel_at<4>();
    case 8: return os_kernel_at<8>();
    case 16: return os_kernel_at<16>();
    case 32: return os_kernel_at<32>();
    case 64: return os_kernel_at<64>();
    case 128: return os_kernel_at<128>();
    case 256: return os_kernel_at<256>();
    case 512: return os_kernel_at<512>();
    case 1024: return os_kernel_at<1024>();
    case 2048: return os_kernel_at<2048>();
    case 4096: return os_kernel_at<4096>();
    case 8192: return os_kernel_at<8192>();
    default: return os_kernel_at<16384>();
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_overlap_save(const float* x, int x_ld, const float* hist, float* y,
                     const float* hf, const float* twf, const float* twi, int channels, int n,
                     int n_fft, int log2n, int taps, int smem_bytes, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Kernel kernel = os_kernel_for(n_fft);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  asp::OsGeo g;
  g.n = n;
  g.x_ld = x_ld;
  g.taps = taps;
  g.blk = n_fft - (taps - 1);
  g.nblk = (n + g.blk - 1) / g.blk;
  g.npair = (g.nblk + 1) / 2;
  g.units = channels * g.npair;
  const int threads = os_threads(n_fft);
  const int batch = threads * os_points(n_fft) / n_fft;
  kernel<<<(g.units + batch - 1) / batch, threads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(x, hist, y,
                                                reinterpret_cast<const float2*>(hf),
                                                reinterpret_cast<const float2*>(twf),
                                                reinterpret_cast<const float2*>(twi), g, log2n);
  return static_cast<int>(cudaGetLastError());
}

// nfft's instantiation: info = {registers a thread, local memory bytes a
// thread (spills), resident CTAs an SM at smem_bytes}.
int asp_overlap_save_info(int nfft, int smem_bytes, int device, int* info) {
  return asp::regs_kernel_info(os_kernel_for(nfft), os_threads(nfft), smem_bytes, device, info);
}

}  // extern "C"
