// Streaming FIR -> noise-gate (-> envelope) step for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/chain_kernel.py:fir_gate_step_fused.  One launch per Chain.step
// block, equal to the JAX package's plain composition
// FIRStage(h, nfft).step -> GateStage.step [-> FIRStage(env_h, pre="abs",
// post_scale=env_scale).step]; the body is asp::fir_gate_step_regs
// (fir_gate_step_regs.cuh), shared with res_fir_gate_step_kernel.cu.
//
// Design.  A cluster of two CTAs per channel (the gate's floor, FIFO and
// release are a scan along the stream; the two CTAs split a block's
// frames and meet through distributed shared memory), one CTA of 512
// threads at nfft 8192.  They run the block's transforms in batches of
// register Stockham transforms: one FIR batch (2B = 8 overlap-save blocks
// at nfft 1024, 5 needed for a block of 4096 at 64 taps) filters the
// block in place in shared memory, two analysis batches of 8 frames take
// its 16 new frames to the FIFO (or to shared memory, the 8 the block
// pops itself), two synthesis batches load the 16 popped spectra straight
// into the inverse's first pass, and an overlap-add pass emits each hop.
// The filtered block, the popped spectra and the gate output (the
// envelope's input) stay in shared memory.  The carry is the plain
// composition's: [FIR history, gate dict, envelope history], so no halo
// is recomputed, unlike the TPU kernel's raw-tail carry.  Any T - 1 < N
// and any Te >= 1 launch; a block whose span or spectra do not fit runs
// the analysis in segments and keeps its popped spectra or the envelope's
// input in device memory.
//
// What bounds it on an H100: the transforms of a block (3 FIR pairs, 8
// analysis and 8 synthesis pairs at the headline, each a half or whole
// round trip through the exchange), on 128 CTAs at 64 channels;
// the envelope MAC adds 129 fmaf per sample.

#include <cuda_runtime.h>

#include "fir_gate_step_regs.cuh"

namespace {

template <int R, int RS, int T>
__global__ void __launch_bounds__(T, 1)
fir_gate_step_kernel(asp::GateStepArgs a, asp::FirEnvArgs f) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x / asp::step_ctas(T);
  const float* xc = a.x + static_cast<size_t>(c) * a.x_ld;
  const int hl = f.taps - 1, b = a.b;
  const float* hc = f.hist + static_cast<size_t>(c) * hl;
  // u[s]: the FIR history before the block, the block, zeros past it
  const auto fill = [xc, hc, hl, b](float* span, int s, int len, float*) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int u = s + i;
      span[i] = u < 0 ? hc[hl + u] : (u < b ? xc[u] : 0.0f);
    }
    __syncthreads();
  };
  asp::fir_gate_step_regs<R, RS, true, T>(a, f, c, reinterpret_cast<float*>(smem4), fill);
}

using Kernel = void (*)(asp::GateStepArgs, asp::FirEnvArgs);

// regs_kernel_for's instantiation for nfft (kRelease unused: the body reads
// the release from its arguments, so one kernel serves both launches).
template <int R, int RS, bool kRelease, int T>
struct FirGateStep {
  static Kernel fn() { return fir_gate_step_kernel<R, RS, T>; }
};

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_fir_gate_step(const asp::GateStepArgs* a, const asp::FirEnvArgs* f,
                      int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Kernel kernel = asp::regs_kernel_for<FirGateStep>(a->nfft, a->has_release);
  return asp::launch_step(kernel, a->nfft, a->channels, smem_bytes, stream, *a, *f);
}

// The instantiation for nfft and release: info = {registers a thread, local
// memory bytes a thread (spills), resident CTAs an SM at smem_bytes}.
int asp_fir_gate_step_info(int nfft, int has_release, int smem_bytes, int device, int* info) {
  const Kernel kernel = asp::regs_kernel_for<FirGateStep>(nfft, has_release);
  return asp::regs_kernel_info(kernel, asp::regs_threads(nfft), smem_bytes, device, info);
}

}  // extern "C"
