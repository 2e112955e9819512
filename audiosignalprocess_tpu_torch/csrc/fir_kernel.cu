// Direct-form FIR with history for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel kernels/fir_kernel.py:fir_mac.
// Per channel y[i] = sum_t h[t] x[i-t], output length == input length,
// with the T-1 samples before x taken from `hist` (zeros when null).
//
// Design.  One CTA per (tile of blockDim.x * kP outputs, channel): 128
// threads of 8, 1024 outputs (fir_kernel.FIR_THREADS), so a stream's block
// of 64 channels x 4096 samples is 256 CTAs on 132 SMs.  The CTA
// stages the reversed taps (hr[j] = h[T-1-j], zero-padded to whole chunks)
// and its window (the tile plus the T-1 samples of halo before it, from
// the history where the tile starts the stream) in shared memory: 16-byte
// loads where the window's first sample of x lies on a 16-byte boundary,
// scalar loads elsewhere.  Thread q then computes the kP consecutive
// outputs from q kP on in kP independent accumulators, the taps in chunks
// of kC (fully unrolled; one guarded tail chunk for T mod kC): a chunk
// reads the thread's kP + kC window samples as 16-byte loads and the
// chunk's taps as 16-byte broadcasts, so a shared load feeds 10 fmaf where
// one feeds one window read and one tap read per fmaf in a plain loop.
// Each output's fmaf chain runs over the taps j = 0 .. T-1 in order, so
// the result is the plain loop's bit for bit.  The window is stored
// through win_swz (bit 5 of an index XORed into bit 2): a quarter warp's
// 16-byte reads at a stride of kP = 8 floats then touch 32 distinct banks,
// where they would touch 16 twice; its 4-float groups stay contiguous.  The
// TPU kernel's double-buffered DMA of the window becomes a plain
// cooperative load: CTAs run concurrently, so the loads of some overlap
// the MACs of others.
//
// What bounds it on an H100: at the envelope's shape (129 taps, 64
// channels x 480000 samples) it is about 7.9 GFLOP of fmaf against 246 MB
// of device memory traffic, about 0.12 ms at 67 TFLOP/s: the FP32 pipes,
// with the shared-memory reads at about 28 cycles of a warp's 32 cycles of
// fmaf a chunk.

#include <cstdint>

#include <cuda_runtime.h>

#include "chain_regs_device.cuh"  // regs_kernel_info

namespace {

constexpr int kP = 8;           // outputs a thread (OUTPUTS)
constexpr int kC = 16;          // taps a chunk (CHUNK)
constexpr int kMaxThreads = 256;

// The window's layout: bits 5 and up of an index XORed into its bits 2 and
// up, as many as a thread's kP / 4 groups of 4 floats need.
__device__ __forceinline__ int win_swz(int w) { return w ^ (((w >> 5) & (kP / 4 - 1)) << 2); }

// The chunk of taps from c0 on (kTail: only the first `rem`) into acc.
template <bool kTail>
__device__ __forceinline__ void mac_chunk(float (&acc)[kP], const float* win, const float* hr,
                                          int o0, int c0, int rem) {
  float w[kP + kC];
#pragma unroll
  for (int m = 0; m < (kP + kC) / 4; ++m) {
    const float4 q = *reinterpret_cast<const float4*>(win + win_swz(o0 + c0 + 4 * m));
    w[4 * m] = q.x;
    w[4 * m + 1] = q.y;
    w[4 * m + 2] = q.z;
    w[4 * m + 3] = q.w;
  }
#pragma unroll
  for (int j4 = 0; j4 < kC / 4; ++j4) {
    const float4 h4 = *reinterpret_cast<const float4*>(hr + c0 + 4 * j4);
    const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * j4 + jj;
      if (kTail && j >= rem) continue;
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[p] = fmaf(hv[jj], w[p + j], acc[p]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fir_mac_kernel(const float* __restrict__ x, int x_ld, const float* __restrict__ hist,
               float* __restrict__ y, const float* __restrict__ taps_rev, int n, int taps) {
  extern __shared__ float4 smem4[];
  const int tp = (taps + kC - 1) / kC * kC;  // taps in whole chunks
  const int tile = blockDim.x * kP;
  const int wl = tile + tp;                  // window floats a chunk may read
  float* hr = reinterpret_cast<float*>(smem4);
  float* win = hr + tp;
  const int c = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int hl = taps - 1;
  for (int j = threadIdx.x; j < tp; j += blockDim.x) hr[j] = j < taps ? taps_rev[j] : 0.0f;
  // window sample i is raw sample t0 + i of [hist (hl) | x (n)]: x[g0 + i]
  const float* xc = x + static_cast<size_t>(c) * x_ld;
  const float* hc = hist ? hist + static_cast<size_t>(c) * hl : nullptr;
  const int g0 = t0 - hl;
  const bool vec = ((reinterpret_cast<uintptr_t>(xc) + 4 * static_cast<intptr_t>(g0)) & 15) == 0;
  const auto raw = [=](int i) {
    const int g = g0 + i;
    if (g < 0) return hc ? hc[t0 + i] : 0.0f;
    return g < n ? xc[g] : 0.0f;
  };
  for (int i = 4 * threadIdx.x; i < wl; i += 4 * blockDim.x) {
    float4 v;
    if (vec && g0 + i >= 0 && g0 + i + 4 <= n) {
      v = *reinterpret_cast<const float4*>(xc + g0 + i);
    } else {
      v = make_float4(raw(i), raw(i + 1), raw(i + 2), raw(i + 3));
    }
    *reinterpret_cast<float4*>(win + win_swz(i)) = v;
  }
  __syncthreads();
  const int o0 = threadIdx.x * kP;
  float acc[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) acc[p] = 0.0f;
  const int full = taps / kC;
#pragma unroll 1
  for (int k = 0; k < full; ++k) mac_chunk<false>(acc, win, hr, o0, k * kC, kC);
  if (full * kC < taps) mac_chunk<true>(acc, win, hr, o0, full * kC, taps - full * kC);
  const int count = min(tile, n - t0) - o0;  // this thread's outputs
  float* yo = y + static_cast<size_t>(c) * n + t0 + o0;
  if (count >= kP && (reinterpret_cast<uintptr_t>(yo) & 15) == 0) {
#pragma unroll
    for (int p = 0; p < kP; p += 4) {
      *reinterpret_cast<float4*>(yo + p) = make_float4(acc[p], acc[p + 1], acc[p + 2], acc[p + 3]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p < count) yo[p] = acc[p];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) with `threads` threads a CTA (a
// multiple of 32 up to 256; fir_kernel.FIR_THREADS).  Returns
// cudaGetLastError() after the launch: 0 on success.  Nothing is
// synchronized or allocated here.
int asp_fir_mac(const float* x, int x_ld, const float* hist, float* y,
                const float* taps_rev, int channels, int n, int taps, int threads,
                int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fir_mac_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = threads * kP;
  const dim3 grid((n + tile - 1) / tile, channels);
  fir_mac_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, x_ld, hist, y, taps_rev, n, taps);
  return static_cast<int>(cudaGetLastError());
}

// info = {registers a thread, local memory bytes a thread (spills),
// resident CTAs an SM at `threads` and smem_bytes}.
int asp_fir_mac_info(int threads, int smem_bytes, int device, int* info) {
  return asp::regs_kernel_info(fir_mac_kernel, threads, smem_bytes, device, info);
}

}  // extern "C"
