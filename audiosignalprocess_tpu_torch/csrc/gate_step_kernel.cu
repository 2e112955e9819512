// Streaming noise-gate step for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/gate_kernel.py:gate_step_fused.  One launch per Chain.step
// block: (carry, x) -> (carry', y), equal to the JAX package's plain
// GateStage.step (the body is asp::gate_step_channel, see
// gate_step_device.cuh).
//
// Design.  One CTA per channel walks the block's frames in order: the
// release is a scan along frames and the OLA a carry from one frame to
// the next, and the floor must be complete before the first mask, so the
// frames of a channel are sequential work.  The TPU kernel's grid-layout
// carries (the FIFO over the (n1, n2) four-step spectrum) do not carry
// over: the carry is the plain step's, bin-major, so a stream may switch
// between this kernel and the plain step at any block.  The positions
// (pos, latencies, end-of-file) arrive as scalars and each CTA derives
// frame validity, floor takes and the 1/WOLA norm from them, so a step
// uploads nothing.
//
// What bounds it on an H100: at the headline (64 channels, block 4096,
// N = 1024, hop 256) a launch is 64 CTAs, each running 8 forward and 8
// inverse complex 1024-point transforms one after the other, so the
// radix-2 stages' latency (one barrier per stage) on under half the SMs
// bounds it.  Splitting analysis across more CTAs is later work.

#include <cuda_runtime.h>

#include "gate_step_device.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) gate_step_kernel(asp::GateStepArgs a) {
  extern __shared__ float4 smem4[];
  const asp::GateSmem s(reinterpret_cast<float*>(smem4), a.nfft);
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < a.nfft / 2; i += blockDim.x) s.tw_s[i] = a.tw[i];
  __syncthreads();
  asp::gate_step_channel(a, c, asp::RowSrc{a.x + static_cast<size_t>(c) * a.x_ld},
                         a.out + static_cast<size_t>(c) * a.b, s);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_gate_step(const asp::GateStepArgs* a, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gate_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_step_kernel<<<a->channels, kThreads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
