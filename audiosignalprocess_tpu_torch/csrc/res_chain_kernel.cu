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
// Design.  The body is chain_kernel.cu's (asp::fir_gate_tiles, same
// schedule: one CTA per (channel, 16-hop tile) recomputing its halo, or
// one CTA per channel walking its tiles when release > 0); only the
// FIR's input changes.  Each time the body asks for a span of the
// resampled stream (its tile's frames, the halo frames and the FIR
// history, about 5.8 k samples at the headline), the CTA stages the raw
// samples that span reads (about 5.4 k at 160/147, the polyphase history
// included, zeros before the file) in shared memory and resamples them
// with the phase bank, also in shared memory (asp::res_range).  The
// resampled signal never leaves the CTA.  The TPU kernel instead feeds
// its matrix unit dense per-row "supercycle" phase matrices, because
// Mosaic cannot reshape 160 lanes into 128; here each resampled sample is
// its nk multiply-adds (21 at 160/147).
//
// What bounds it on an H100: as chain_kernel.cu, the FFT work (about 500
// float32 flops per output sample); the resample adds 2*nk = 42 flops per
// resampled sample, recomputed for the halo, and reads the raw file once
// plus the halo (about 113 MB at the headline).

#include <cuda_runtime.h>

#include "chain_device.cuh"
#include "resample_device.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
res_fir_noise_gate_kernel(const float* __restrict__ x, int n, int n_res,
                          float* __restrict__ out,
                          const float* __restrict__ noise_floor,
                          const float* __restrict__ win,
                          const float2* __restrict__ hf,
                          const float2* __restrict__ tw,
                          const float* __restrict__ inv_tab,
                          const float* __restrict__ bank, asp::ResGeo rg,
                          asp::ChainGeo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* bank_s = smem + asp::chain_smem_floats(g);  // up * nk
  float* raw_s = bank_s + rg.up * rg.nk;              // raw window of a span
  const int c = blockIdx.y;
  asp::res_load_bank(bank_s, bank, rg);  // read after res_range's first barrier
  const asp::RawSrc src{nullptr, 0, x + static_cast<size_t>(c) * n, n};
  const auto fill = [&](float* span, int s, int len) {
    asp::res_range(rg, bank_s, raw_s, src, s, len, 0, n_res,
                   [span](int i, float v) { span[i] = v; });
  };
  asp::fir_gate_tiles(g, smem, c, out + static_cast<size_t>(c) * g.out_len, noise_floor,
                      win, hf, tw, inv_tab, fill);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
// n: raw samples per channel; n_res = ceil(n*up/down).
int asp_res_fir_noise_gate(const float* x, float* out, const float* noise_floor,
                           const float* win, const float* hf, const float* tw,
                           const float* inv_tab, const float* bank, int channels,
                           int n, int n_res, int up, int down, int nk, int nfft,
                           int log2n, int hop, int taps, int nframes, int mf,
                           int sequential, float thresh_gain, float att,
                           float release, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const asp::ChainGeo g = asp::chain_geo(nfft, log2n, hop, taps, nframes, mf, sequential,
                                         thresh_gain, att, release);
  const asp::ResGeo rg{up, down, nk, 0};
  err = cudaFuncSetAttribute(res_fir_noise_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sequential ? 1 : g.ntiles, channels);
  res_fir_noise_gate_kernel<<<grid, kThreads, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      x, n, n_res, out, noise_floor, win, reinterpret_cast<const float2*>(hf),
      reinterpret_cast<const float2*>(tw), inv_tab, bank, rg, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
