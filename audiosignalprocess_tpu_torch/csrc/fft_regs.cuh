// Radix-2 stages held in registers, for Hopper (sm_90a): the
// decimation-in-time passes of fft_radix2_lanes and fft_radix2_stages, the
// constant-geometry (Pease) passes of fft_pease_lanes, and the self-sorting
// (Stockham) passes of fft_stockham_lanes, fft_stockham_manual and the
// half-size transforms of rfft_stockham and irfft_stockham.
//
// Decimation in time.  A thread holds R = 2^r points of a row and runs up
// to r consecutive stages on them with no barrier; points go through a
// buffer only between groups of stages ("passes").  Pass [s0, s1) acts on
// index bits s0..s1-1, so a thread's R points are those whose indices
// differ only in the r-bit field at bit f = s1 - r (f = s0 except in a
// shorter last pass), and slot j of the thread holds index
//
//     dit_index(g, j, f) = ((g >> f) << (f + r)) | (j << f) | (g & (2^f - 1))
//
// for its group g.  Stage s pairs x[q 2m + p] with x[q 2m + m + p]
// (m = 2^s) under the twiddle w = exp(sign i pi p / m): slot j and slot
// j + 2^(s - f), with p = ((j mod 2^(s - f)) << f) | (g mod 2^f).  The
// twiddles come from a per-stage table: stage s's 2^s values at offset
// 2^s - 1 (n - 1 entries for n points), so the p of neighbouring groups are
// neighbouring entries (or one entry, broadcast), never a stride; or,
// where fft_radix2_stages reads device memory (its first pass, and every
// pass above 8192 points), from its stacked (log2 n, n/2) table, row s
// (entry s n/2 + p: the same float32 values).
//
// The exchange buffer between passes is addressed through dit_swizzle,
// which XORs the low five bits of an index with bits 4..8 and 9..13: every
// warp access of the passes above is then conflict-free for n up to 2^14
// (one address per bank), with no padding.
//
// Constant geometry.  A Pease stage butterflies the points whose indices
// differ in the top bit and rotates every index left by one bit (u =
// A[k], v = A[k + n/2] -> B[2k] = u + v, B[2k + 1] = (u - v) w_s[k], w_s[k]
// = exp(sign 2 pi i ((k >> s) << s) / n)).  A thread that holds the R = 2^r
// points g + t n/R of its group g (indices that differ only in their top r
// bits) runs r consecutive stages with no exchange, and its slot j then
// holds index g R + j.  So every pass has one data flow: read R points at
// stride n/R, write R consecutive points (the radix-R Korn-Lambiotte
// form).  Within a pass from stage s0, after b stages slot j holds index
// (j mod 2^(r-b)) 2^(L-r+b) + g 2^b + (j >> (r-b)) (L = log2 n); stage
// s0 + b pairs slot j with slot j + 2^(r-b-1), and its k >> s is
// ((j mod 2^(r-b-1)) 2^(L-r) + g) >> s0.  The twiddles come from a
// per-stage table: stage s's n/2^(s+1) values w_s[m 2^s] at offset
// n - n/2^s (n - 1 entries), read as neighbouring entries in the first pass
// and as one broadcast entry in the later ones.
//
// The Pease exchange is addressed through pease_swizzle, which XORs bits
// 5..8 of an index into bits 0..3 and their parity into bit 4, and bits
// 9..11 into bits 0..2: the writes (a thread's R consecutive points,
// neighbouring threads R apart), the strided reads and the last pass's
// bit-reversed reads (below 512 points across rows) then touch 32 banks
// per warp access for every n up to 2^13 (a search over those patterns).
// It is XOR-linear, so swizzle(a | b) = swizzle(a) ^ swizzle(b) for a and b
// on disjoint bits, and it leaves bits 0..3 and every bit above 4 alone.
//
// Stockham.  The self-sorting radix-2 stage s reads index bits [l: top s
// bits][c: bit L-1-s][p: low L-1-s bits] (L = log2 n) and writes u + w v,
// u - w v (w = exp(sign i pi l / 2^s)) to [c][l][p], so r consecutive stages
// s0 .. s0+r-1 act on disjoint sets of R = 2^r points: those that share l
// (s0 bits) and p (pw = L-r-s0 bits).  A thread that holds such a set, slot
// j read from index l 2^(L-s0) + j 2^pw + p (stride 2^pw), runs the r stages
// in registers: stage s0 + b pairs slot j with slot j + 2^(r-1-b) under the
// segment l_b = brev_b(j >> (r-b)) 2^s0 + l (the outputs of the earlier
// stages of the pass are the segment's top bits), and slot j ends at index
// brev_r(j) 2^(L-r) + l 2^pw + p (stride n/R).  Group v = l 2^pw + p of a
// row thus reads R points at stride 2^pw from its block of the row and
// writes them at stride n/R from v: the same stages, pairs, operands and
// twiddles as the radix-2 loop, four stages a pass.  The twiddles come from
// a per-stage table (stage s's 2^s values at 2^s - 1, n - 1 entries) read
// from device memory through the L1 cache: the groups of a warp share l or
// hold neighbouring l, so they read one broadcast entry or neighbouring
// ones, never a stride.  The exchange
// between passes is addressed through pease_swizzle: every warp access of
// the Stockham passes (the strided reads, the writes at stride n/R) then
// touches 32 banks for n up to 2^13 (tests/test_torch_fft_stockham_regs.py
// checks every pattern); dit_swizzle leaves the later passes' reads in
// conflict.  A pass reads its points through a loader and writes them
// through a storer, and its halves are routines of their own
// (stockham_group: the loads and the stages of one group; stockham_put: its
// stores), so the real kernels run the same body on their own ends:
// rfft_stockham's pack (z[k] = x[2k] + i x[2k+1], one float2 load) and its
// last pass, which untangles two groups in registers; irfft_stockham's
// first pass, which untangles two groups as it loads them, and its scaled,
// interleaved store.
#pragma once

#include <cuda_runtime.h>

namespace asp {

// The complex product a b (tap-spectrum and twiddle products).
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// k < 2^bits (bits <= 4) bit-reversed: a constant for a constant k
__device__ __forceinline__ constexpr int brev_bits(int k, int bits) {
  return (((k & 1) << 3) | ((k & 2) << 1) | ((k & 4) >> 1) | ((k & 8) >> 3)) >> (4 - bits);
}

// log2 of a pass's points a group (2, 4, 8 or 16)
__device__ __forceinline__ constexpr int pass_bits(int rp) {
  return rp == 2 ? 1 : rp == 4 ? 2 : rp == 8 ? 3 : 4;
}

__device__ __forceinline__ int dit_index(int g, int j, int f, int r) {
  return ((g >> f) << (f + r)) | (j << f) | (g & ((1 << f) - 1));
}

__device__ __forceinline__ int dit_swizzle(int i) {
  return i ^ ((i >> 4) & 31) ^ ((i >> 9) & 31);
}

// The stages s0 <= s < s1 of one pass on a thread's R points (slot j at
// bit field f), in order; `low` is the group's bits below f, `tw` the
// per-stage table, or with kStacked the stacked one (rows of `half`
// entries).  Every slot index is a compile-time constant, so the points
// stay in registers.
template <int R, bool kStacked = false>
__device__ __forceinline__ void dit_pass(float2 (&v)[R], const float2* tw, int s0, int s1,
                                         int f, int low, int half = 0) {
  constexpr int r = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  static_assert(R == 1 << r, "R is 2, 4, 8 or 16");
#pragma unroll
  for (int b = 0; b < r; ++b) {
    const int s = f + b;
    if (s < s0 || s >= s1) continue;
    const float2* ws = tw + (kStacked ? s * half : (1 << s) - 1);
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

__device__ __forceinline__ int pease_swizzle(int i) {
  const int x = (i >> 5) & 15;
  return i ^ x ^ ((__popc(x) & 1) << 4) ^ ((i >> 9) & 7);
}

// The r = log2 R stages s0 <= s < s0 + r of one Pease pass on the R points
// of group g (slot t holding index g + t n/R on entry, g R + t on return);
// `tw` holds the per-stage table from entry `off` on (stage s at n - n/2^s
// - off).  Every slot index is a compile-time constant, so the points stay
// in registers.
template <int R>
__device__ __forceinline__ void pease_pass(float2 (&v)[R], const float2* tw, int s0, int log2n,
                                           int g, int off) {
  constexpr int r = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  static_assert(R == 1 << r, "R is 2, 4, 8 or 16");
  const int n = 1 << log2n;
#pragma unroll
  for (int b = 0; b < r; ++b) {
    const int s = s0 + b;
    const float2* ws = tw + (n - (n >> s) - off);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int h = 1 << (r - b - 1);
      if (j & h) continue;
      const float2 w = ws[(((j & (h - 1)) << (log2n - r)) | g) >> s0];
      const float2 u = v[j];
      const float2 x = v[j + h];
      const float dr = u.x - x.x, di = u.y - x.y;
      v[j] = make_float2(u.x + x.x, u.y + x.y);
      v[j + h] = make_float2(dr * w.x - di * w.y, dr * w.y + di * w.x);
    }
  }
}

// The r = log2 R stages s0 <= s < s0 + r of one Stockham pass on the R
// points of a group with segment bits l (slot j holding index l 2^(L-s0) +
// j 2^pw + p on entry, brev_r(j) 2^(L-r) + l 2^pw + p on return); `tw` is
// the per-stage table (stage s at 2^s - 1) in device memory, read through
// the L1 cache.  Every slot index is a compile-time constant, so the points
// stay in registers.
template <int R>
__device__ __forceinline__ void stockham_pass(float2 (&v)[R], const float2* tw, int s0, int l) {
  constexpr int r = pass_bits(R);
  static_assert(R == 1 << r, "R is 2, 4, 8 or 16");
#pragma unroll
  for (int b = 0; b < r; ++b) {
    const float2* ws = tw + ((1 << (s0 + b)) - 1) + l;
    const int h = 1 << (r - 1 - b);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & h) continue;
      const float2 w = __ldg(ws + (brev_bits(j >> (r - b), b) << s0));
      const float2 u = v[j];
      const float2 x = v[j + h];
      const float2 t = make_float2(x.x * w.x - x.y * w.y, x.x * w.y + x.y * w.x);
      v[j] = make_float2(u.x + t.x, u.y + t.y);
      v[j + h] = make_float2(u.x - t.x, u.y - t.y);
    }
  }
}

// A pair of re/im planes, read and written at an index.
struct PlanarIn {
  const float* re;
  const float* im;
  __device__ __forceinline__ float2 operator()(int i) const { return make_float2(re[i], im[i]); }
};

struct PlanarOut {
  float* re;
  float* im;
  __device__ __forceinline__ void operator()(int i, float2 v) const {
    re[i] = v.x;
    im[i] = v.y;
  }
};

// The read side of one group of a Stockham pass of RP = 2^rp points a group
// from stage s0 over rows of n = 2^log2n points: group v is row v >> lg, q
// = v mod 2^lg (lg = log2n - rp), q = l 2^pw + p.  It reads slot j as
// load(i) at the row's index l 2^(log2n - s0) + j 2^pw + p (`rsw` holds
// slot bit k's offset, swizzled where `swz_in`) and runs stockham_pass.
// Returns the group's write base, row n + q: slot j belongs at base +
// brev_rp(j) 2^lg.
template <int RP, class Load>
__device__ __forceinline__ int stockham_group(float2 (&x)[RP], int v, int log2n, int s0,
                                              Load load, bool swz_in,
                                              const int (&rsw)[pass_bits(RP)],
                                              const float2* tw) {
  constexpr int rp = pass_bits(RP);
  const int lg = log2n - rp, pw = lg - s0;
  const int row = v >> lg, q = v & ((1 << lg) - 1);
  const int l = q >> pw;
  const int ri = (row << log2n) | (l << (log2n - s0)) | (q & ((1 << pw) - 1));
  const int i0 = swz_in ? pease_swizzle(ri) : ri;
#pragma unroll
  for (int j = 0; j < RP; ++j) {
    int i = i0;
#pragma unroll
    for (int k = 0; k < rp; ++k) {
      if (j & (1 << k)) i ^= rsw[k];
    }
    x[j] = load(i);
  }
  stockham_pass<RP>(x, tw, s0, l);
  return (row << log2n) | q;
}

// Slot bit k's read offset 2^(pw + k) of a pass from s0, swizzled where `swz`.
template <int RP>
__device__ __forceinline__ void stockham_read_offsets(int (&rsw)[pass_bits(RP)], int log2n,
                                                      int s0, bool swz) {
  const int pw = log2n - pass_bits(RP) - s0;
#pragma unroll
  for (int k = 0; k < pass_bits(RP); ++k) {
    rsw[k] = swz ? pease_swizzle(1 << (pw + k)) : 1 << (pw + k);
  }
}

// Slot bit k's write offset 2^(lg + k) of a pass, swizzled where `swz`.
template <int RP>
__device__ __forceinline__ void stockham_write_offsets(int (&wsw)[pass_bits(RP)], int log2n,
                                                       bool swz) {
  const int lg = log2n - pass_bits(RP);
#pragma unroll
  for (int k = 0; k < pass_bits(RP); ++k) {
    wsw[k] = swz ? pease_swizzle(1 << (lg + k)) : 1 << (lg + k);
  }
}

// The write side of one group of a pass: slot j as store(i, x[j]) at index
// wo + brev_rp(j) 2^lg (`wsw` from stockham_write_offsets), through
// pease_swizzle where `swz_out`.
template <int RP, class Store>
__device__ __forceinline__ void stockham_put(const float2 (&x)[RP], int wo, bool swz_out,
                                             const int (&wsw)[pass_bits(RP)], Store store) {
  constexpr int rp = pass_bits(RP);
  const int o0 = swz_out ? pease_swizzle(wo) : wo;
#pragma unroll
  for (int j = 0; j < RP; ++j) {
    int i = o0;
#pragma unroll
    for (int k = 0; k < rp; ++k) {
      if (brev_bits(j, rp) & (1 << k)) i ^= wsw[k];
    }
    store(i, x[j]);
  }
}

// One Stockham pass of RP points a group from stage s0 over `rows` rows:
// stockham_group and stockham_put on every group.  Indices are relative to
// the CTA's rows (row n + index), through pease_swizzle where `swz_in`/
// `swz_out` (the exchange) and as they are elsewhere (device memory, or the
// copy ring's slot in natural order).  Every thread of the block calls it.
template <int RP, class Load, class Store>
__device__ __forceinline__ void stockham_groups(int rows, int log2n, int s0, Load load,
                                                bool swz_in, Store store, bool swz_out,
                                                const float2* tw) {
  constexpr int rp = pass_bits(RP);
  int rsw[rp], wsw[rp];
  stockham_read_offsets<RP>(rsw, log2n, s0, swz_in);
  stockham_write_offsets<RP>(wsw, log2n, swz_out);
  for (int v = threadIdx.x; v < rows << (log2n - rp); v += blockDim.x) {
    float2 x[RP];
    const int wo = stockham_group<RP>(x, v, log2n, s0, load, swz_in, rsw, tw);
    stockham_put<RP>(x, wo, swz_out, wsw, store);
  }
}

// The same pass from the planes (sr, si) to the planes (dr, di).
template <int RP>
__device__ __forceinline__ void stockham_groups(int rows, int log2n, int s0, const float* sr,
                                                const float* si, bool swz_in, float* dr,
                                                float* di, bool swz_out, const float2* tw) {
  stockham_groups<RP>(rows, log2n, s0, PlanarIn{sr, si}, swz_in, PlanarOut{dr, di}, swz_out,
                      tw);
}

}  // namespace asp
