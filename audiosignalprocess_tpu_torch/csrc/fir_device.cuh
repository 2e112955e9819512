// Block-cooperative FIR building blocks for Hopper (sm_90a): the
// overlap-save block pair and the direct-form MAC tile that the FIR,
// overlap-save and step kernels share.
//
// Both read their input through a source functor `src(j)` over "raw"
// coordinates: raw sample j is [history (T-1 samples) | x][j], zero past
// the end of x.  Output sample i of the filter is then
// y[i] = sum_t h[t] raw[i + T-1 - t], the causal FIR with that history.
#pragma once

#include <cuda_runtime.h>

#include "fft_device.cuh"

namespace asp {

// raw sample j of [hist (hl samples) | x (n samples)], zero past the end;
// a null `hist` reads as zeros (a cold start).
struct HistSrc {
  const float* hist;
  const float* x;
  int hl;
  int n;
  __device__ __forceinline__ float operator()(int j) const {
    if (j < hl) return hist ? hist[j] : 0.0f;
    j -= hl;
    return j < n ? x[j] : 0.0f;
  }
};

// Overlap-save blocks k and, when `two`, k+1 through one complex
// transform: block k (raw[k*blk, k*blk + N)) as the real part, block
// k+1 as the imaginary part; the taps are real, so the two filtered
// blocks come back apart.  On return, for i < blk,
//   z[T-1+i].x * (1/N) is y[k*blk + i] and z[T-1+i].y * (1/N) is
//   y[(k+1)*blk + i],
// with blk = N - (T-1).  hf: the full N-point spectrum of the zero-padded
// taps; tw: the N/2 twiddles (see fft_shared).  Every thread calls it.
template <class Src>
__device__ void os_block_pair(float2* z, const Src& raw, int k, bool two,
                              int blk, int n_fft, int log2n,
                              const float2* __restrict__ hf, const float2* tw) {
  const int base = k * blk;
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x)
    z[i] = make_float2(raw(base + i), two ? raw(base + blk + i) : 0.0f);
  __syncthreads();
  fft_shared(z, n_fft, log2n, false, tw);
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x) z[i] = cmul(z[i], hf[i]);
  __syncthreads();
  fft_shared(z, n_fft, log2n, true, tw);
}

// Direct-form MAC over one tile: out[o] = scale * sum_j hr[j] * win[o + j]
// for o < count, with hr the taps reversed (hr[j] = h[T-1-j]) and win the
// raw samples from the tile's first output on (count + T - 1 of them),
// both in shared memory.  Neighbouring threads take neighbouring outputs,
// so the window reads are conflict-free and the tap read is a broadcast.
__device__ __forceinline__ void mac_tile(const float* win, const float* hr,
                                         int taps, int count, float scale,
                                         float* __restrict__ out) {
  for (int o = threadIdx.x; o < count; o += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < taps; ++j) acc = fmaf(hr[j], win[o + j], acc);
    out[o] = acc * scale;
  }
}

}  // namespace asp
