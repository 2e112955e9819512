// The streaming FIR -> noise-gate (-> envelope) step on one channel, for
// Hopper (sm_90a): the device body that fir_gate_step_kernel.cu and
// res_fir_gate_step_kernel.cu share.  It computes the JAX package's plain
// composition FIRStage(h, nfft).step -> GateStage.step [->
// FIRStage(env_h, pre="abs", post_scale=env_scale).step] on one block:
//
//   1. FIR: the block, with the carried T-1 samples of history before it,
//      by overlap-save (two blocks per complex transform,
//      asp::os_block_pair), into a per-channel scratch row;
//   2. gate: asp::gate_step_channel on [gate in_tail | filtered block];
//   3. envelope, when folded in: |y| with the carried Te-1 samples of
//      rectified history, direct-form MAC with the envelope taps in
//      shared memory (asp::mac_tile), times env_scale.
#pragma once

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

constexpr int kEnvTile = 1024;

// Floats of shared memory the body uses past the gate's (GateSmem): the
// envelope taps and its MAC window, when folded in.
__device__ __forceinline__ int env_smem_floats(const FirEnvArgs& f) {
  return f.env_taps > 0 ? 2 * f.env_taps - 1 + kEnvTile : 0;
}

// One block of the step on channel c.  xrow: the channel's b input
// samples.  Every thread calls it.
__device__ inline void fir_gate_step_channel(const GateStepArgs& a, const FirEnvArgs& f,
                                             int c, const float* xrow, const GateSmem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.nfft, b = a.b, hl = f.taps - 1;
  const float inv_n = 1.0f / static_cast<float>(N);
  for (int i = tid; i < N / 2; i += nt) s.tw_s[i] = a.tw[i];
  __syncthreads();

  // ---- 1. FIR of [history | x] into the filtered scratch row
  const HistSrc raw{f.hist + static_cast<size_t>(c) * hl, xrow, hl, b};
  float* filt = f.filtered + static_cast<size_t>(c) * b;
  const int blk = N - hl;
  const int nblk = (b + blk - 1) / blk;
  for (int k = 0; k < nblk; k += 2) {
    const bool two = k + 1 < nblk;
    os_block_pair(s.z, raw, k, two, blk, N, a.log2n, f.hf, s.tw_s);
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
  gate_step_channel(a, c, RowSrc{filt}, gate_y, s);
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
    mac_tile(win, hr, te, count, f.env_scale, out + t0);
    __syncthreads();
  }
  for (int i = tid; i < ehl; i += nt)
    f.env_hist_out[static_cast<size_t>(c) * ehl + i] = rect(b + i);
}

}  // namespace asp
