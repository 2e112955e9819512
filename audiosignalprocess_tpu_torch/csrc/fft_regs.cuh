// Radix-2 decimation-in-time stages held in registers, for Hopper (sm_90a).
//
// A thread holds R = 2^r points of a row and runs up to r consecutive
// stages on them with no barrier; points go through a buffer only between
// groups of stages ("passes").  Pass [s0, s1) acts on index bits s0..s1-1,
// so a thread's R points are those whose indices differ only in the r-bit
// field at bit f = s1 - r (f = s0 except in a shorter last pass), and slot
// j of the thread holds index
//
//     dit_index(g, j, f) = ((g >> f) << (f + r)) | (j << f) | (g & (2^f - 1))
//
// for its group g.  Stage s pairs x[q 2m + p] with x[q 2m + m + p]
// (m = 2^s) under the twiddle w = exp(sign i pi p / m): slot j and slot
// j + 2^(s - f), with p = ((j mod 2^(s - f)) << f) | (g mod 2^f).  The
// twiddles come from a per-stage table: stage s's 2^s values at offset
// 2^s - 1 (n - 1 entries for n points), so the p of neighbouring groups are
// neighbouring entries (or one entry, broadcast), never a stride.
//
// The exchange buffer between passes is addressed through dit_swizzle,
// which XORs the low five bits of an index with bits 4..8 and 9..13: every
// warp access of the passes above is then conflict-free for n up to 2^14
// (one address per bank), with no padding.
#pragma once

#include <cuda_runtime.h>

namespace asp {

__device__ __forceinline__ int dit_index(int g, int j, int f, int r) {
  return ((g >> f) << (f + r)) | (j << f) | (g & ((1 << f) - 1));
}

__device__ __forceinline__ int dit_swizzle(int i) {
  return i ^ ((i >> 4) & 31) ^ ((i >> 9) & 31);
}

// The stages s0 <= s < s1 of one pass on a thread's R points (slot j at
// bit field f), in order; `low` is the group's bits below f, `tw` the
// per-stage table.  Every slot index is a compile-time constant, so the
// points stay in registers.
template <int R>
__device__ __forceinline__ void dit_pass(float2 (&v)[R], const float2* tw, int s0, int s1,
                                         int f, int low) {
  constexpr int r = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  static_assert(R == 1 << r, "R is 2, 4, 8 or 16");
#pragma unroll
  for (int b = 0; b < r; ++b) {
    const int s = f + b;
    if (s < s0 || s >= s1) continue;
    const float2* ws = tw + ((1 << s) - 1);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & (1 << b)) continue;
      const float2 w = ws[((j & ((1 << b) - 1)) << f) | low];
      const float2 u = v[j];
      const float2 x = v[j + (1 << b)];
      const float2 t = make_float2(x.x * w.x - x.y * w.y, x.x * w.y + x.y * w.x);
      v[j] = make_float2(u.x + t.x, u.y + t.y);
      v[j + (1 << b)] = make_float2(u.x - t.x, u.y - t.y);
    }
  }
}

}  // namespace asp
