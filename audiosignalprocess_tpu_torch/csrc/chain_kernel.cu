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
// shared-memory traffic of the transforms bound it, not device memory.
//
// The body is asp::fir_gate_regs (chain_regs_device.cuh), shared with the
// resampling variant res_chain_kernel.cu; this kernel feeds it raw samples.
// It runs the transforms of a batch (4 at nfft 1024) as register Stockham
// passes, 3 each way at nfft 1024 with the per-bin work (the tap product,
// the gate's untangle, mask and retangle) between the forward's last and
// the inverse's first pass in registers: 4 exchanges a batch of 8 frames,
// each transform's two warps meeting at their own barrier between passes
// and the CTA twice a batch, where the radix-2 body took 27 CTA barriers a
// frame pair.  At nfft 8192 a batch is one transform of 512 threads with
// one exchange buffer and the span in device memory
// (chain_regs_device.cuh); past 8192 the wrapper raises (SMEM_LIMIT).

#include <cuda_runtime.h>

#include "chain_regs_device.cuh"

namespace {

template <int R, int RS, bool kRelease, int T>
__global__ void __launch_bounds__(T, 2 * asp::kRegsThreads / T)
fir_noise_gate_kernel(const float* __restrict__ x, int n, float* __restrict__ out,
                      const float* __restrict__ noise_floor,
                      const float* __restrict__ win,
                      const float2* __restrict__ hf,
                      const float2* __restrict__ twf,
                      const float2* __restrict__ twi,
                      const float* __restrict__ inv_tab, asp::ChainGeo g,
                      float* span_rows) {
  extern __shared__ float4 smem[];
  const int c = blockIdx.y;
  const float* xc = x + static_cast<size_t>(c) * n;
  const auto fill = [xc, n](float* span, int s, int len, float*) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int gi = s + i;
      span[i] = (gi >= 0 && gi < n) ? xc[gi] : 0.0f;
    }
    __syncthreads();
  };
  asp::fir_gate_regs<R, RS, kRelease, true, T>(g, reinterpret_cast<float*>(smem), c,
                            out + static_cast<size_t>(c) * g.out_len, noise_floor, win, hf,
                            twf, twi, inv_tab, span_rows, fill);
}

using Kernel = void (*)(const float*, int, float*, const float*, const float*, const float2*,
                        const float2*, const float2*, const float*, asp::ChainGeo, float*);

template <int R, int RS, bool kRelease, int T>
struct FirNoiseGate {
  static Kernel fn() { return fir_noise_gate_kernel<R, RS, kRelease, T>; }
};

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
// span_rows: at nfft 8192 the CTAs' spans (fir_gate_regs), else null.
int asp_fir_noise_gate(const float* x, float* out, const float* noise_floor,
                       const float* win, const float* hf, const float* twf, const float* twi,
                       const float* inv_tab, float* span_rows, int channels, int n,
                       int nfft, int log2n, int hop, int taps, int nframes, int mf,
                       int sequential, float thresh_gain,
                       float att, float release, int smem_bytes, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const asp::ChainGeo g = asp::chain_geo(nfft, log2n, hop, taps, nframes, mf, sequential,
                                         thresh_gain, att, release);
  const Kernel kernel = asp::regs_kernel_for<FirNoiseGate>(nfft, sequential);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sequential ? 1 : g.ntiles, channels);
  kernel<<<grid, asp::regs_threads(g.nfft), smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, n, out, noise_floor, win, reinterpret_cast<const float2*>(hf),
      reinterpret_cast<const float2*>(twf), reinterpret_cast<const float2*>(twi), inv_tab, g,
      span_rows);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for nfft and the launch: info = {registers a thread,
// local memory bytes a thread (spills), resident CTAs an SM at smem_bytes}.
int asp_fir_noise_gate_info(int nfft, int sequential, int smem_bytes, int device, int* info) {
  const Kernel kernel = asp::regs_kernel_for<FirNoiseGate>(nfft, sequential);
  return asp::regs_kernel_info(kernel, asp::regs_threads(nfft), smem_bytes, device, info);
}

const char* asp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
