// Streaming phase-vocoder step for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/stretch_kernel.py:stretch_step_fused.  One launch per
// Chain.step block of StretchStage: (carry, x) -> (carry', y), x of m*hop
// samples, y of mo*hop = m*q/p*hop samples, equal to the JAX package's
// plain StretchStage.step with the same carry (kernels/stretch_kernel.py
// documents it), so a stream may switch between this kernel and the
// plain step at any block.
//
// Design.  The body is asp::stretch_step_regs (stretch_step_regs.cuh): a
// cluster of two CTAs per channel (one CTA of 512 threads at nfft 8192)
// running the block's transforms in batches of register Stockham
// transforms.  At 4/3, block 4096, nfft 1024, hop 256 (16 analysis and 12
// synthesis frames) each CTA takes one analysis batch of 8 frames (their
// spectra to the FIFO in device memory, z0 from the first true frame) and
// one synthesis batch (8 frames and 4): the per-bin rotor recursion along
// the batch's frames, the inverse with the synthesis bins in its merged
// first pass, and an overlap-add pass that emits each finished hop.  The
// positions arrive as scalars (hit, i0, the emitted frames [lo, hi),
// eof_out) and the slot/frac tables are uploaded once per geometry, so a
// step uploads nothing.  The TPU kernel ran the four-step grid FFT over
// the full spectrum with a batch tile of channels and the FIFO in VMEM;
// none of that layout carries over: the FIFO (depth x (N/2+1) complex per
// channel, 593 KB at 147/160) lives in device memory and is read back
// through L2.
//
// What bounds it on an H100 at 4/3 (64 channels): the bytes, the block in
// and out, the FIFO read and written and its slots s0, s1 read back (about
// 8 MB, 0.0025 ms at 3.35 TB/s), above the operations of 14 complex
// 1024-point transforms a channel.  What it pays above that is the
// latency of a CTA's half round trips, the recursion's reads of the FIFO
// through L2 (one thread a bin, the frames in order), the second CTA's
// rotors over the first's frames, and the cluster's meetings.

#include <cuda_runtime.h>

#include "stretch_step_regs.cuh"

namespace {

template <int R, int RS, int T>
__global__ void __launch_bounds__(T, 1) stretch_step_kernel(asp::StretchStepArgs a) {
  extern __shared__ float4 smem4[];
  asp::stretch_step_regs<R, RS, T>(a, blockIdx.x / asp::step_ctas(T),
                                   reinterpret_cast<float*>(smem4));
}

using Kernel = void (*)(asp::StretchStepArgs);

// regs_kernel_for's instantiation for nfft (the vocoder has no release).
template <int R, int RS, bool kRelease, int T>
struct StretchStep {
  static Kernel fn() { return stretch_step_kernel<R, RS, T>; }
};

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_stretch_step(const asp::StretchStepArgs* a, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Kernel kernel = asp::regs_kernel_for<StretchStep, false>(a->nfft);
  return asp::launch_step(kernel, a->nfft, a->channels, smem_bytes, stream, *a);
}

// The instantiation for nfft: info = {registers a thread, local memory
// bytes a thread (spills), resident CTAs an SM at smem_bytes}.
int asp_stretch_step_info(int nfft, int smem_bytes, int device, int* info) {
  const Kernel kernel = asp::regs_kernel_for<StretchStep, false>(nfft);
  return asp::regs_kernel_info(kernel, asp::regs_threads(nfft), smem_bytes, device, info);
}

}  // extern "C"
