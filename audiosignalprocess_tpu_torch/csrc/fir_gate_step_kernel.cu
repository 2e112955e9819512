// Streaming FIR -> noise-gate (-> envelope) step for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/chain_kernel.py:fir_gate_step_fused.  One launch per Chain.step
// block, equal to the JAX package's plain composition
// FIRStage(h, nfft).step -> GateStage.step [-> FIRStage(env_h, pre="abs",
// post_scale=env_scale).step]; the body is asp::fir_gate_step_channel
// (fir_gate_step_device.cuh), shared with res_fir_gate_step_kernel.cu.
//
// Design.  One CTA per channel does all three in order, so the filtered
// block and the gate output never leave the CTA's view (they go through
// scratch rows in device memory, which stay in L2).  The carry is the
// plain composition's: [FIR history, gate dict, envelope history], so no
// halo is recomputed, unlike the TPU kernel's raw-tail carry, which
// refilters nfft-hop samples of halo each block to keep its row layout.
// The TPU wrapper's Mosaic limits on the tap counts (_os_rows_ok,
// _env_fits) do not apply: any T - 1 < N and any Te >= 1 launch here.
//
// What bounds it on an H100: as gate_step_kernel.cu, the CTA's sequential
// transforms (at the headline 3 FIR pairs, 8 analysis and 8 synthesis
// pairs per block) on one CTA per channel; the envelope MAC adds
// 129 fmaf per sample.

#include <cuda_runtime.h>

#include "fir_gate_step_device.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
fir_gate_step_kernel(asp::GateStepArgs a, asp::FirEnvArgs f) {
  extern __shared__ float4 smem4[];
  const asp::GateSmem s(reinterpret_cast<float*>(smem4), a.nfft);
  const int c = blockIdx.x;
  asp::fir_gate_step_channel(a, f, c, a.x + static_cast<size_t>(c) * a.x_ld, s);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_fir_gate_step(const asp::GateStepArgs* a, const asp::FirEnvArgs* f,
                      int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fir_gate_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fir_gate_step_kernel<<<a->channels, kThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(*a, *f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
