// Fused resample -> FIR -> spectral noise gate for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/res_chain_kernel.py:resample_fir_gate_fused, the whole-file
// front half of the 44.1 -> 48 kHz flagship chain.  Per channel the result
// equals oracle.noise_gate(oracle.fir_direct(oracle.resample_poly(x, up,
// down, zero_phase=False), h), ...): the causal polyphase resample of the
// file (ceil(n*up/down) samples, zeros past them), the causal FIR, the
// STFT gate with WOLA, output length nfft + (F-1)*hop for the frames F of
// the resampled length.
//
// Design.  The body is chain_kernel.cu's (asp::fir_gate_regs,
// chain_regs_device.cuh: the same schedule, batched register Stockham
// transforms, the per-bin work in registers); only the FIR's input
// changes.  Each time the body asks for a span of the resampled stream
// (its tile's frames, the halo frames and the FIR history, about 7.8 k
// samples at the headline), the CTA stages the raw samples that span reads
// (about 7.2 k at 160/147, the polyphase history included, zeros before
// the file) and the phase bank in the tail of its shared memory (the
// exchange buffers, free until the FIR's first pass) and resamples them
// there (asp::res_span, resample_device.cuh: the polyphase MAC with the
// phases stepped, not divided).  The resampled signal never leaves the CTA.  The
// TPU kernel instead feeds its matrix unit dense per-row "supercycle"
// phase matrices, because Mosaic cannot reshape 160 lanes into 128; here
// each resampled sample is its nk multiply-adds (21 at 160/147).
//
// What bounds it on an H100: as chain_kernel.cu, the FFT work (about 500
// float32 flops per output sample); the resample adds 2*nk = 42 flops per
// resampled sample, recomputed for the halo, and reads the raw file once
// plus the halo (about 113 MB at the headline).

#include <cuda_runtime.h>

#include "chain_regs_device.cuh"
#include "resample_device.cuh"

namespace {

template <int R, int RS, bool kRelease, int T>
__global__ void __launch_bounds__(T, 2 * asp::kRegsThreads / T)
res_fir_noise_gate_kernel(const float* __restrict__ x, int n, int n_res,
                          float* __restrict__ out,
                          const float* __restrict__ noise_floor,
                          const float* __restrict__ win,
                          const float2* __restrict__ hf,
                          const float2* __restrict__ twf,
                          const float2* __restrict__ twi,
                          const float* __restrict__ inv_tab,
                          const float* __restrict__ bank, asp::ResGeo rg,
                          asp::ChainGeo g, float* span_rows) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.y;
  const asp::RawSrc src{nullptr, 0, x + static_cast<size_t>(c) * n, n};
  const auto fill = [&](float* span, int s, int len, float* scratch) {
    float* bank_s = scratch;             // up * nk
    float* raw_s = bank_s + rg.up * rg.nk;  // raw window of the span
    asp::res_load_bank(bank_s, bank, rg);  // read after res_span's first barrier
    asp::res_span(rg, bank_s, raw_s, src, s, len, n_res, span);
  };
  asp::fir_gate_regs<R, RS, kRelease, true, T>(g, reinterpret_cast<float*>(smem4), c,
                            out + static_cast<size_t>(c) * g.out_len, noise_floor, win, hf,
                            twf, twi, inv_tab, span_rows, fill);
}

using Kernel = void (*)(const float*, int, int, float*, const float*, const float*,
                        const float2*, const float2*, const float2*, const float*,
                        const float*, asp::ResGeo, asp::ChainGeo, float*);

template <int R, int RS, bool kRelease, int T>
struct ResFirNoiseGate {
  static Kernel fn() { return res_fir_noise_gate_kernel<R, RS, kRelease, T>; }
};

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
// n: raw samples per channel; n_res = ceil(n*up/down); span_rows: at nfft
// 8192 the CTAs' spans (fir_gate_regs), else null.
int asp_res_fir_noise_gate(const float* x, float* out, const float* noise_floor,
                           const float* win, const float* hf, const float* twf,
                           const float* twi, const float* inv_tab, const float* bank,
                           float* span_rows, int channels, int n, int n_res, int up,
                           int down, int nk, int nfft, int log2n, int hop, int taps,
                           int nframes, int mf,
                           int sequential, float thresh_gain, float att,
                           float release, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const asp::ChainGeo g = asp::chain_geo(nfft, log2n, hop, taps, nframes, mf, sequential,
                                         thresh_gain, att, release);
  const asp::ResGeo rg{up, down, nk, 0};
  const Kernel kernel = asp::regs_kernel_for<ResFirNoiseGate>(nfft, sequential);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sequential ? 1 : g.ntiles, channels);
  kernel<<<grid, asp::regs_threads(g.nfft), smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, n, n_res, out, noise_floor, win, reinterpret_cast<const float2*>(hf),
      reinterpret_cast<const float2*>(twf), reinterpret_cast<const float2*>(twi), inv_tab,
      bank, rg, g, span_rows);
  return static_cast<int>(cudaGetLastError());
}

// As asp_fir_noise_gate_info, for this kernel's instantiation for nfft.
int asp_res_fir_noise_gate_info(int nfft, int sequential, int smem_bytes, int device, int* info) {
  const Kernel kernel = asp::regs_kernel_for<ResFirNoiseGate>(nfft, sequential);
  return asp::regs_kernel_info(kernel, asp::regs_threads(nfft), smem_bytes, device, info);
}

}  // extern "C"
