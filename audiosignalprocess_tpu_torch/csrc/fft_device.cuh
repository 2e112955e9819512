// Block-cooperative complex FFT in shared memory, for Hopper (sm_90a).
//
// The device-side transform every fused kernel of this package uses. It
// takes the place of the TPU package's in-kernel four-step transforms
// (kernels/fft_kernel.py: fourstep_grid_fwd, fourstep_grid_inv_real),
// which exist to map the FFT onto the TPU's matrix unit; here the
// transform is plain radix-2 butterflies in float32 on the SM's cores.
//
// Conventions (the package's ops/fft.py): natural order in and out, the
// forward transform is X[k] = sum_j x[j] exp(-2 pi i j k / n).  Both
// directions are unnormalized here; the caller folds 1/n into its own
// scaling (n is a power of two, so the scale is exact).
#pragma once

#include <cuda_runtime.h>

namespace asp {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place FFT of n = 2^log2n (log2n >= 1) complex points in `buf`.
//
// buf: shared memory, n points, natural order on entry and on return.
// tw:  n/2 twiddles, tw[k] = exp(-2 pi i k / n), computed in float64 on
//      the host and stored as float32 (shared or global memory).
// inverse: use conj(tw), i.e. the exp(+2 pi i j k / n) kernel.
//
// Every thread of the block must call it, with `buf` complete on entry
// (a __syncthreads() between the last write and the call).  It returns
// after a __syncthreads(), so the result may be read at once.  Any block
// size works: threads stride over the n/2 butterflies of each stage.
__device__ inline void fft_shared(float2* buf, int n, int log2n, bool inverse,
                                  const float2* tw) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // bit-reversal permutation: each swapped pair belongs to its lower index
  for (int i = tid; i < n; i += nt) {
    const int r = static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
    if (i < r) {
      const float2 t = buf[i];
      buf[i] = buf[r];
      buf[r] = t;
    }
  }
  __syncthreads();
  const float sgn = inverse ? -1.0f : 1.0f;
  // decimation in time: stage s merges sub-transforms of size 2^s
  for (int s = 0; s < log2n; ++s) {
    const int half = 1 << s;
    const int tw_shift = log2n - 1 - s;  // twiddle stride n / 2^(s+1)
    for (int b = tid; b < (n >> 1); b += nt) {
      const int pos = b & (half - 1);
      const int i0 = ((b >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      float2 w = tw[pos << tw_shift];
      w.y *= sgn;
      const float2 u = buf[i0];
      const float2 v = cmul(buf[i1], w);
      buf[i0] = make_float2(u.x + v.x, u.y + v.y);
      buf[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

}  // namespace asp
