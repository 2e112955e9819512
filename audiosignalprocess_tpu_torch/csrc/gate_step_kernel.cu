// Streaming noise-gate step for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/gate_kernel.py:gate_step_fused.  One launch per Chain.step
// block: (carry, x) -> (carry', y), equal to the JAX package's plain
// GateStage.step with the same carry (planar spectral FIFO of nf frames,
// per-bin floor sum, OLA tail, release state; pos and floor_n as scalars),
// so a stream may switch between this kernel and the plain step at any
// block.
//
// Design.  The body is the FIR -> gate step's (asp::fir_gate_step_regs,
// fir_gate_step_regs.cuh) with the FIR switched off at compile time (kFir
// false): the fill stores the block's raw samples into the span the
// analysis frames read, after the in_tail part.  A cluster of two CTAs per
// channel (one CTA of 512 threads at nfft 8192), each taking half of the
// block's batches of register Stockham transforms: at the headline (block
// 4096, nfft 1024, hop 256) one analysis batch of 8 new frames (the
// spectra to the FIFO, or to shared memory for the 8 the block pops
// itself) and one synthesis batch of 8 popped frames, the mask and the
// release in the merged pass, then an overlap-add pass that emits each
// finished hop.  The two CTAs meet after the analysis (the floor's two
// parts), before the second's first overlap-add (the first's carry) and
// before either exits.  The positions (pos, latencies, end-of-file)
// arrive as scalars, so a step uploads nothing.  The TPU kernel's
// grid-layout carries (the FIFO over the four-step spectrum) do not carry
// over.
//
// What bounds it on an H100 at the headline: the bytes of a launch, 64 x
// 4096 samples in and out and the carry read and written (the FIFO's 8
// frames x 513 bins dominate: 7.3 MB, 0.0022 ms at 3.35 TB/s), above the
// operations (16 complex 1024-point transforms a channel, 52 MFLOP, 0.0008
// ms at 67 TFLOP/s).  What it pays above that is the latency of a CTA's
// two half round trips (128 CTAs on 132 SMs), the exchange between passes
// and the cluster's meetings.

#include <cuda_runtime.h>

#include "fir_gate_step_regs.cuh"

namespace {

template <int R, int RS, int T>
__global__ void __launch_bounds__(T, 1)
gate_step_kernel(asp::GateStepArgs a, asp::FirEnvArgs f) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x / asp::step_ctas(T);
  const float* xc = a.x + static_cast<size_t>(c) * a.x_ld;
  // x[s + i], s >= 0 and s + len <= b (the body reads no sample past the block)
  const auto fill = [xc](float* span, int s, int len, float*) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) span[i] = xc[s + i];
    __syncthreads();
  };
  asp::fir_gate_step_regs<R, RS, false, T>(a, f, c, reinterpret_cast<float*>(smem4), fill);
}

using Kernel = void (*)(asp::GateStepArgs, asp::FirEnvArgs);

// regs_kernel_for's instantiation for nfft (kRelease unused: the body reads
// the release from its arguments, so one kernel serves both launches).
template <int R, int RS, bool kRelease, int T>
struct GateStep {
  static Kernel fn() { return gate_step_kernel<R, RS, T>; }
};

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_gate_step(const asp::GateStepArgs* a, const asp::FirEnvArgs* f, int smem_bytes,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Kernel kernel = asp::regs_kernel_for<GateStep>(a->nfft, a->has_release);
  return asp::launch_step(kernel, a->nfft, a->channels, smem_bytes, stream, *a, *f);
}

// The instantiation for nfft and release: info = {registers a thread, local
// memory bytes a thread (spills), resident CTAs an SM at smem_bytes}.
int asp_gate_step_info(int nfft, int has_release, int smem_bytes, int device, int* info) {
  const Kernel kernel = asp::regs_kernel_for<GateStep>(nfft, has_release);
  return asp::regs_kernel_info(kernel, asp::regs_threads(nfft), smem_bytes, device, info);
}

}  // extern "C"
