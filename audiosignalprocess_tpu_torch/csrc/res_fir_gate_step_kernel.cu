// Streaming resample -> FIR -> noise-gate (-> envelope) step for Hopper
// (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/res_chain_kernel.py:res_fir_gate_step_fused: the whole config-5
// chain, one launch per Chain.step block.  It equals the JAX package's
// plain composition ResampleStage(up, down).step -> FIRGateStage.step:
//
//   0. resample: [res_hist | x] (hn carried raw samples, then the b_in of
//      the block) through the causal polyphase filter into a per-channel
//      scratch row of b_out = b_in*up/down samples (asp::res_range, in
//      tiles of kResTile outputs, phase bank and raw window in shared
//      memory); the new res_hist is the last hn raw samples;
//   1-3. FIR, gate and envelope on that row: fir_gate_step_kernel.cu's
//      body, asp::fir_gate_step_channel.
//
// Design.  One CTA per channel, as the FIR -> gate step: the gate's
// frames are sequential work.  The carry is the plain composition's,
// [res_hist, [FIR history, gate dict, envelope history]], which the plain
// step shares, so a stream may switch between the two at any block.  The
// TPU kernel's float32 carry (a dict with res_hist and a raw tail of
// resampled rows in its grid layout) is not reproduced.  The resampled
// row goes through device memory (it stays in L2); the TPU kernel's
// supercycle phase matrices, needed there because Mosaic cannot reshape
// 160 lanes into 128, become the plain polyphase MAC: 21 fmaf per
// resampled sample at 160/147.
//
// What bounds it on an H100: as fir_gate_step_kernel.cu, the CTA's
// sequential transforms on one CTA per channel; the resample adds about
// 5120 * 21 fmaf per channel and block at the headline, a few percent.

#include <cuda_runtime.h>

#include "fir_gate_step_device.cuh"
#include "resample_device.cuh"

namespace asp {

// Field for field the ctypes structure ResStepArgs of
// kernels/res_chain_kernel.py.  Per channel contiguous: res_hist (hn),
// resampled (b_out, the rows GateStepArgs.x points to); x row stride x_ld.
struct ResStepArgs {
  const float* x;
  const float* res_hist;
  float* res_hist_out;
  float* resampled;
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

constexpr int kThreads = 512;
constexpr int kResTile = 2048;

__global__ void __launch_bounds__(kThreads)
res_fir_gate_step_kernel(asp::GateStepArgs a, asp::FirEnvArgs f, asp::ResStepArgs r) {
  extern __shared__ float4 smem4[];
  const asp::GateSmem s(reinterpret_cast<float*>(smem4), a.nfft);
  const int c = blockIdx.x;
  const int b_out = a.b;
  // the resampler's shared memory follows the gate's and the envelope's
  float* bank_s = s.acc + a.ring + asp::env_smem_floats(f);  // up * nk
  float* win_s = bank_s + r.up * r.nk;                       // raw window of a tile
  const asp::ResGeo g{r.up, r.down, r.nk, 0};

  // ---- 0. resample [res_hist | x] into the channel's scratch row
  asp::res_load_bank(bank_s, r.bank, g);  // read after res_range's first barrier
  const asp::RawSrc src{r.res_hist + static_cast<size_t>(c) * r.hn, r.hn,
                        r.x + static_cast<size_t>(c) * r.x_ld, r.b_in};
  float* row = r.resampled + static_cast<size_t>(c) * b_out;
  for (int j0 = 0; j0 < b_out; j0 += kResTile) {
    float* dst = row + j0;
    asp::res_range(g, bank_s, win_s, src, j0, min(kResTile, b_out - j0), 0, b_out,
                   [dst](int i, float v) { dst[i] = v; });
  }
  for (int i = threadIdx.x; i < r.hn; i += blockDim.x)
    r.res_hist_out[static_cast<size_t>(c) * r.hn + i] = src(r.b_in - r.hn + i);

  // ---- 1-3. FIR -> gate (-> envelope) on the resampled row (the body
  // starts with a barrier, after which the row is visible to every thread)
  asp::fir_gate_step_channel(a, f, c, row, s);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_res_fir_gate_step(const asp::GateStepArgs* a, const asp::FirEnvArgs* f,
                          const asp::ResStepArgs* r, int smem_bytes, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(res_fir_gate_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  res_fir_gate_step_kernel<<<a->channels, kThreads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(*a, *f, *r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
