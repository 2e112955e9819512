// Streaming resample -> FIR -> noise-gate (-> envelope) step for Hopper
// (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/res_chain_kernel.py:res_fir_gate_step_fused: the whole config-5
// chain, one launch per Chain.step block.  It equals the JAX package's
// plain composition ResampleStage(up, down).step -> FIRGateStage.step:
// [res_hist | x] (hn carried raw samples, then the b_in of the block)
// through the causal polyphase filter, b_out = b_in*up/down resampled
// samples, then fir_gate_step_kernel.cu's FIR, gate and envelope.
//
// Design.  The body is fir_gate_step_kernel.cu's (asp::fir_gate_step_regs,
// fir_gate_step_regs.cuh); only the FIR's input changes.  Each time the
// body asks for a span of the FIR's input, the CTA stages the (up, nk)
// phase bank and the raw samples the span reads in the tail of its shared
// memory (the exchange buffers, free until the FIR's first pass) and
// resamples them straight into the span (asp::res_span), the FIR history
// before them: the resampled block never leaves the CTA.  The carry is the
// plain composition's, [res_hist, [FIR history, gate dict, envelope
// history]], which the plain step shares, so a stream may switch between
// the two at any block.  The TPU kernel's float32 carry (res_hist and a
// raw tail of resampled rows in its grid layout) is not reproduced; its
// supercycle phase matrices, needed there because Mosaic cannot reshape
// 160 lanes into 128, become the plain polyphase MAC: 21 fmaf per
// resampled sample at 160/147.
//
// What bounds it on an H100: as fir_gate_step_kernel.cu, the transforms of
// a block (3 FIR pairs, 10 analysis and 10 synthesis pairs at 5120
// resampled samples), on a cluster of two CTAs per channel; the resample
// adds about 5120 * 21 fmaf per channel and block.

#include <cuda_runtime.h>

#include "fir_gate_step_regs.cuh"
#include "resample_device.cuh"

namespace asp {

// Field for field the ctypes structure ResStepArgs of
// kernels/res_chain_kernel.py.  Per channel contiguous: res_hist (hn); x
// row stride x_ld.
struct ResStepArgs {
  const float* x;
  const float* res_hist;
  float* res_hist_out;
  const float* bank;  // (up, nk), each phase's taps reversed
  int x_ld;
  int b_in;
  int hn;
  int up;
  int down;
  int nk;
};

}  // namespace asp

namespace {

template <int R, int RS, int T>
__global__ void __launch_bounds__(T, 1)
res_fir_gate_step_kernel(asp::GateStepArgs a, asp::FirEnvArgs f, asp::ResStepArgs r) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x / asp::step_ctas(T);
  const asp::ResGeo g{r.up, r.down, r.nk, 0};
  const asp::RawSrc src{r.res_hist + static_cast<size_t>(c) * r.hn, r.hn,
                        r.x + static_cast<size_t>(c) * r.x_ld, r.b_in};
  for (int i = threadIdx.x; i < r.hn; i += blockDim.x) {
    r.res_hist_out[static_cast<size_t>(c) * r.hn + i] = src(r.b_in - r.hn + i);
  }
  const int hl = f.taps - 1, b_out = a.b;
  const float* hc = f.hist + static_cast<size_t>(c) * hl;
  // u[s]: the FIR history before the resampled block, the resampled block
  // (output s of [res_hist | x]'s causal resample), zeros past it
  const auto fill = [&](float* span, int s, int len, float* scratch) {
    const int nh = min(max(-s, 0), len);
    for (int i = threadIdx.x; i < nh; i += blockDim.x) span[i] = hc[hl + s + i];
    float* bank_s = scratch;                  // up * nk
    float* raw_s = bank_s + r.up * r.nk;      // raw window of the span
    asp::res_load_bank(bank_s, r.bank, g);    // read after res_span's first barrier
    asp::res_span(g, bank_s, raw_s, src, s + nh, len - nh, b_out, span + nh);
  };
  asp::fir_gate_step_regs<R, RS, true, T>(a, f, c, reinterpret_cast<float*>(smem4), fill);
}

using Kernel = void (*)(asp::GateStepArgs, asp::FirEnvArgs, asp::ResStepArgs);

// regs_kernel_for's instantiation for nfft (kRelease unused: the body reads
// the release from its arguments, so one kernel serves both launches).
template <int R, int RS, bool kRelease, int T>
struct ResFirGateStep {
  static Kernel fn() { return res_fir_gate_step_kernel<R, RS, T>; }
};

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_res_fir_gate_step(const asp::GateStepArgs* a, const asp::FirEnvArgs* f,
                          const asp::ResStepArgs* r, int smem_bytes, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Kernel kernel = asp::regs_kernel_for<ResFirGateStep>(a->nfft, a->has_release);
  return asp::launch_step(kernel, a->nfft, a->channels, smem_bytes, stream, *a, *f, *r);
}

// As asp_fir_gate_step_info, for this kernel's instantiation.
int asp_res_fir_gate_step_info(int nfft, int has_release, int smem_bytes, int device,
                               int* info) {
  const Kernel kernel = asp::regs_kernel_for<ResFirGateStep>(nfft, has_release);
  return asp::regs_kernel_info(kernel, asp::regs_threads(nfft), smem_bytes, device, info);
}

}  // extern "C"
