// Polyphase rational resampler building blocks for Hopper (sm_90a): the
// phase bank in shared memory, the raw-sample source, and a
// block-cooperative range of resampled outputs.  The resample kernel, the
// whole-file resample -> FIR -> gate kernel and its streaming step share
// them, so the three cannot disagree on the index arithmetic.
//
// With up/down reduced and `delay` the zero-phase advance ((T-1)/2, or 0
// for the causal stream), output j of the resampled stream is
//   y[j] = sum_k h[p + up*k] * raw[m - k],   j*down + delay = m*up + p,
// where raw is the input in its own coordinates: negative indices read
// the carried history (zeros for a cold start), indices past the end read
// zeros.  This is the JAX package's ops/resample.resample_poly; with a
// history of H samples its block output j is the whole stream's output
// j + H*up/down, which is why the history starts at raw index -H.
#pragma once

#include <cuda_runtime.h>

namespace asp {

struct ResGeo {
  int up;     // reduced
  int down;
  int nk;     // taps per phase, ceil(T / up)
  int delay;  // 0: causal
};

// raw sample r of [hist (hn samples) | x (n samples)] in x's coordinates
struct RawSrc {
  const float* hist;  // null: a cold start (zeros before x)
  int hn;
  const float* x;
  int n;
  __device__ __forceinline__ float operator()(int r) const {
    if (r < 0) return (hist && r >= -hn) ? hist[hn + r] : 0.0f;
    return r < n ? x[r] : 0.0f;
  }
};

// The (up, nk) phase bank into shared memory.  `bank` holds each phase's
// taps reversed, bank[p*nk + i] = h[p + up*(nk-1-i)] (zero past the
// taps), so an output reads its raw window in ascending order.  The caller
// synchronizes before the bank is read (res_range does).
__device__ __forceinline__ void res_load_bank(float* bank_s, const float* __restrict__ bank,
                                              const ResGeo& g) {
  for (int i = threadIdx.x; i < g.up * g.nk; i += blockDim.x) bank_s[i] = bank[i];
}

// The resampled outputs [j0, j0 + count) of the stream: dst(i, y[j0 + i])
// for i < count, and dst(i, 0) where j0 + i lies outside [lo, hi) (the
// resampled signal of a finite file ends; its polyphase continuation past
// the end is not part of it).  The raw window those outputs read,
// res_window(count) samples at most (see the wrappers), is staged from
// src into win_s; each thread then takes neighbouring outputs, nk fmaf
// each in a fixed tap order.  Every thread calls it; it returns after a
// __syncthreads(), so dst's writes to shared memory may be read at once.
template <class Src, class Dst>
__device__ void res_range(const ResGeo& g, const float* bank_s, float* win_s,
                          const Src& src, int j0, int count, int lo, int hi,
                          const Dst& dst) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int jf = max(j0, lo), jl = min(j0 + count, hi);
  const auto newest = [&g](int j) {
    return static_cast<int>((static_cast<long long>(j) * g.down + g.delay) / g.up);
  };
  int r0 = 0;
  if (jl > jf) {
    r0 = newest(jf) - (g.nk - 1);
    const int rn = newest(jl - 1) - r0 + 1;
    for (int i = tid; i < rn; i += nt) win_s[i] = src(r0 + i);
  }
  __syncthreads();
  for (int i = tid; i < count; i += nt) {
    const int j = j0 + i;
    float acc = 0.0f;
    if (j >= jf && j < jl) {
      const long long pos = static_cast<long long>(j) * g.down + g.delay;
      const int m = static_cast<int>(pos / g.up);
      const int p = static_cast<int>(pos - static_cast<long long>(m) * g.up);
      const float* w = win_s + (m - (g.nk - 1) - r0);
      const float* b = bank_s + p * g.nk;
      for (int t = 0; t < g.nk; ++t) acc = fmaf(b[t], w[t], acc);
    }
    dst(i, acc);
  }
  __syncthreads();
}

// floor(a / b) for b > 0
__device__ __forceinline__ long long floor_div(long long a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The resampled outputs [j0, j0 + count) into span[0, count), zero outside
// [0, n_res): asp::res_range's values (the same staged raw window, taps and
// fmaf order), but each thread steps its outputs' phase and newest raw
// index by 256 outputs at a time instead of dividing (64-bit) per output.
// Returns after a __syncthreads().
__device__ __forceinline__ void res_span(const ResGeo& g, const float* bank_s, float* win_s,
                                         const RawSrc& src, int j0, int count, int n_res,
                                         float* span) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int jf = max(j0, 0), jl = min(j0 + count, n_res);
  int r0 = 0;
  if (jl > jf) {
    r0 = static_cast<int>(static_cast<long long>(jf) * g.down / g.up) - (g.nk - 1);
    const int rn = static_cast<int>(static_cast<long long>(jl - 1) * g.down / g.up) - r0 + 1;
    for (int i = tid; i < rn; i += nt) win_s[i] = src(r0 + i);
  }
  __syncthreads();
  // output j = j0 + i reads raw m - k (m = floor(j down / up)) with phase
  // p = j down - m up; thread tid starts at i = tid and steps by nt
  const long long pos = static_cast<long long>(j0 + tid) * g.down;
  long long m = floor_div(pos, g.up);
  int p = static_cast<int>(pos - m * g.up);
  const int step_m = nt * g.down / g.up, step_p = nt * g.down - step_m * g.up;
  for (int i = tid; i < count; i += nt) {
    const int j = j0 + i;
    float acc = 0.0f;
    if (j >= jf && j < jl) {
      const float* w = win_s + (static_cast<int>(m) - (g.nk - 1) - r0);
      const float* b = bank_s + p * g.nk;
      for (int t = 0; t < g.nk; ++t) acc = fmaf(b[t], w[t], acc);
    }
    span[i] = acc;
    m += step_m;
    p += step_p;
    if (p >= g.up) {
      p -= g.up;
      ++m;
    }
  }
  __syncthreads();
}

}  // namespace asp
