// Streaming FIR -> noise-gate (-> envelope) step for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/chain_kernel.py:fir_gate_step_fused.  One launch per Chain.step
// block, equal to the JAX package's plain composition
// FIRStage(h, nfft).step -> GateStage.step [-> FIRStage(env_h, pre="abs",
// post_scale=env_scale).step]:
//
//   1. FIR: the block, with the carried T-1 samples of history before it,
//      by overlap-save (two blocks per complex transform,
//      asp::os_block_pair), into a per-channel scratch row;
//   2. gate: asp::gate_step_channel on [gate in_tail | filtered block];
//   3. envelope, when folded in: |y| with the carried Te-1 samples of
//      rectified history, direct-form MAC with the envelope taps in
//      shared memory (asp::mac_tile), times env_scale.
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

#include "fir_device.cuh"
#include "gate_step_device.cuh"

namespace asp {

// Field for field the ctypes structure FirEnvArgs of
// kernels/chain_kernel.py.  Per channel contiguous: hist (T-1), filtered
// and gate_out scratch rows (b), env_hist (Te-1).
struct FirEnvArgs {
  const float* hist;
  float* hist_out;
  const float2* hf;       // N-point spectrum of the zero-padded FIR taps
  float* filtered;
  const float* env_hist;
  float* env_hist_out;
  const float* env_taps_rev;
  float* gate_out;
  int taps;
  int env_taps;           // 0: no envelope
  float env_scale;
};

}  // namespace asp

namespace {

constexpr int kThreads = 512;
constexpr int kEnvTile = 1024;

__global__ void __launch_bounds__(kThreads)
fir_gate_step_kernel(asp::GateStepArgs a, asp::FirEnvArgs f) {
  extern __shared__ float4 smem4[];
  const asp::GateSmem s(reinterpret_cast<float*>(smem4), a.nfft);
  const int c = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.nfft, b = a.b, hl = f.taps - 1;
  const float inv_n = 1.0f / static_cast<float>(N);
  for (int i = tid; i < N / 2; i += nt) s.tw_s[i] = a.tw[i];
  __syncthreads();

  // ---- 1. FIR of [history | x] into the filtered scratch row
  const asp::HistSrc raw{f.hist + static_cast<size_t>(c) * hl,
                         a.x + static_cast<size_t>(c) * a.x_ld, hl, b};
  float* filt = f.filtered + static_cast<size_t>(c) * b;
  const int blk = N - hl;
  const int nblk = (b + blk - 1) / blk;
  for (int k = 0; k < nblk; k += 2) {
    const bool two = k + 1 < nblk;
    asp::os_block_pair(s.z, raw, k, two, blk, N, a.log2n, f.hf, s.tw_s);
    for (int i = tid; i < blk; i += nt) {
      const float2 v = s.z[hl + i];
      const int o = k * blk + i;
      if (o < b) filt[o] = v.x * inv_n;
      if (two && o + blk < b) filt[o + blk] = v.y * inv_n;
    }
    __syncthreads();
  }
  for (int i = tid; i < hl; i += nt) f.hist_out[static_cast<size_t>(c) * hl + i] = raw(b + i);
  __syncthreads();  // the filtered row is read by every thread below

  // ---- 2. gate
  const bool env = f.env_taps > 0;
  float* gate_y = (env ? f.gate_out : a.out) + static_cast<size_t>(c) * b;
  asp::gate_step_channel(a, c, asp::RowSrc{filt}, gate_y, s);
  if (!env) return;
  __syncthreads();

  // ---- 3. envelope: |y| -> direct-form FIR with history -> * env_scale
  const int te = f.env_taps, ehl = te - 1;
  float* hr = s.acc + a.ring;  // te taps, then the window
  float* win = hr + te;        // kEnvTile + te - 1
  const float* eh = f.env_hist + static_cast<size_t>(c) * ehl;
  auto rect = [&](int j) { return j < ehl ? eh[j] : fabsf(gate_y[j - ehl]); };
  for (int j = tid; j < te; j += nt) hr[j] = f.env_taps_rev[j];
  float* out = a.out + static_cast<size_t>(c) * b;
  for (int t0 = 0; t0 < b; t0 += kEnvTile) {
    const int count = min(kEnvTile, b - t0);
    for (int i = tid; i < count + ehl; i += nt) win[i] = rect(t0 + i);
    __syncthreads();
    asp::mac_tile(win, hr, te, count, f.env_scale, out + t0);
    __syncthreads();
  }
  for (int i = tid; i < ehl; i += nt)
    f.env_hist_out[static_cast<size_t>(c) * ehl + i] = rect(b + i);
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
