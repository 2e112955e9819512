// Fused FIR -> spectral noise gate for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/chain_kernel.py:fir_noise_gate_fused.  Per channel the result
// equals oracle.noise_gate(oracle.fir_direct(x, h), nfft, hop, ...):
// causal FIR with zero history by FFT overlap-save, then frames at k*hop,
// periodic window, forward FFT, a hard per-bin mask against the noise
// floor (an input: the wrapper computes it from the filtered signal's
// first frames with plain torch on the device, as the TPU package does
// in XLA outside its kernel), optional max-with-decay release along
// frames, inverse FFT, window, overlap-add, times the clamped 1/WOLA norm.
//
// Design.  The TPU kernel walks a grid that runs in order on one core
// and carries two things from one grid step to the next: the OLA spill
// (the nfft-hop samples a tile's last frames add past its end) and the
// release state.  Blocks on the GPU run in parallel and in no order, so
// neither carry is reproduced in the default launch:
//
// - release == 0: one CTA per (channel, tile of MF hops of output).  A
//   CTA recomputes everything its tile needs from raw input: the
//   nfft/hop-1 frames before the tile that overlap into it (the halo)
//   and the taps-1 samples of FIR history before those.  It writes its
//   tile once; no CTA reads another's result.  This is the same halo
//   recomputation the TPU kernel uses for the FIR, applied to the OLA
//   spill as well.
// - release > 0: the release state s_q = max(m_q, r*s_{q-1}) is a true
//   scan over all frames and cannot be recomputed from a halo.  The same
//   kernel is launched with one CTA per channel that walks its tiles in
//   order, each tile processing only its own MF frames, with the OLA
//   spill and the (nfft/2+1)-bin release state kept in shared memory.
//
// Real transforms go two to a complex FFT: two overlap-save blocks as
// re/im (the taps are real, so the filtered blocks come back as re/im),
// and two gate frames as re/im, untangled per bin pair (k, n-k) for the
// mask and put back together before the inverse.  Everything is float32;
// twiddles and the tap spectrum are computed in float64 on the host.
//
// What bounds it on an H100, at the headline shape (64 channels x
// 480000 samples, 64 taps, nfft 1024, hop 256): device memory moves
// about 123 MB in and 123 MB out, about 0.07 ms at 3.35 TB/s.  The
// arithmetic is about 500 float32 flops per sample with full complex
// 1024-point FFTs (two for the FIR per 961 samples, two for the gate per
// 256-sample hop), about 15 GFLOP in all.  So FFT arithmetic and the
// shared-memory traffic of the butterflies bound it, not device memory.
// This simple design halves the FFT count with the two-for-one packing,
// keeps every intermediate (raw span, filtered span, spectra, OLA tile)
// in shared memory, and pays for it with radix-2 stages (one shared
// memory round trip and one barrier per stage) and the halo recompute
// (MF + nfft/hop - 1 frames and about MF*hop + 2*(nfft-hop) filtered
// samples per MF*hop output samples).  Radix-8 in registers and a
// persistent schedule are later work.
//
// The body is asp::fir_gate_tiles (chain_device.cuh), shared with the
// resampling variant res_chain_kernel.cu; this kernel feeds it raw samples.

#include <cuda_runtime.h>

#include "chain_device.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fir_noise_gate_kernel(const float* __restrict__ x, int n, float* __restrict__ out,
                      const float* __restrict__ noise_floor,
                      const float* __restrict__ win,
                      const float2* __restrict__ hf,
                      const float2* __restrict__ tw,
                      const float* __restrict__ inv_tab, asp::ChainGeo g) {
  extern __shared__ float4 smem[];
  const int c = blockIdx.y;
  const float* xc = x + static_cast<size_t>(c) * n;
  const auto fill = [xc, n](float* span, int s, int len) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int gi = s + i;
      span[i] = (gi >= 0 && gi < n) ? xc[gi] : 0.0f;
    }
    __syncthreads();
  };
  asp::fir_gate_tiles(g, reinterpret_cast<float*>(smem), c,
                      out + static_cast<size_t>(c) * g.out_len, noise_floor, win,
                      hf, tw, inv_tab, fill);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_fir_noise_gate(const float* x, float* out, const float* noise_floor,
                       const float* win, const float* hf, const float* tw,
                       const float* inv_tab, int channels, int n, int nfft,
                       int log2n, int hop, int taps, int nframes, int mf,
                       int sequential, float thresh_gain,
                       float att, float release, int smem_bytes, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const asp::ChainGeo g = asp::chain_geo(nfft, log2n, hop, taps, nframes, mf, sequential,
                                         thresh_gain, att, release);
  err = cudaFuncSetAttribute(fir_noise_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sequential ? 1 : g.ntiles, channels);
  fir_noise_gate_kernel<<<grid, kThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      x, n, out, noise_floor, win, reinterpret_cast<const float2*>(hf),
      reinterpret_cast<const float2*>(tw), inv_tab, g);
  return static_cast<int>(cudaGetLastError());
}

const char* asp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
