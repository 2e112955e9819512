// The whole-file FIR -> spectral noise gate body on batched register
// Stockham transforms, for Hopper (sm_90a): what chain_kernel.cu,
// res_chain_kernel.cu and gate_kernel.cu share, and the overlap-save FIR
// of os_kernel.cu on the same round trip (os_regs, at the end).  The first
// two differ only in where the FIR's input comes from (the raw samples, or
// the resampled stream), which each kernel passes in as a `fill` functor;
// gate_kernel.cu runs the gate alone (kFir false: no FIR section, the fill
// stores the gate's input and the span holds only the tile's frames).
//
// Per channel the body computes oracle.noise_gate(oracle.fir_direct(u, h),
// nfft, hop, ...) of its input u: causal FIR with zero history by FFT
// overlap-save, frames at k*hop, periodic window, forward FFT, a hard
// per-bin mask against the noise floor (an input, computed by the wrapper),
// optional max-with-decay release along frames, inverse FFT, window,
// overlap-add, times the clamped 1/WOLA norm.  Schedule: with release == 0,
// one CTA per (channel, tile of mf hops of output) recomputes the halo its
// tile needs (the nfft/hop - 1 frames before it and the FIR history before
// those), so no CTA reads another's result; with release > 0 (a scan over
// all frames), one CTA per channel walks its tiles in order, carrying the
// overlap-add spill and the release state in shared memory.
//
// Emission.  With inv_tab null the output is the un-normalized overlap-add
// (one time shard of the gate, whose caller adds the spill into its right
// neighbour and divides by the WOLA norm at global positions).  The output
// length is g.out_len, which may run past the last frame's end (a shard's
// l + d samples with only its first n_valid frames analysed, n_valid maybe
// 0): each tile writes 0 at its positions past that end.
//
// Transforms.  A thread holds R = 16 points of a transform (R = nfft below
// 16), so an N-point transform takes N/R threads and the 256 threads of a
// CTA run B = 256 R / N transforms at once (a batch: 4 at N = 1024).  The
// passes are fft_regs.cuh's Stockham routines (stockham_group,
// stockham_pass, stockham_put) on the plan of rfft_stockham's half-size
// transform: forward passes of 4 stages (a pass of 3 first where log2 N -
// rs is not a multiple of 4) and a last pass of rs = log2 N mod 4 stages (1
// where that is 0); the inverse runs the same sizes in reverse order.
// Between passes the points of a batch cross two exchange buffers of
// re/im planes through pease_swizzle; the twiddles come from the per-stage
// tables (stockham_table(N, -1) and (N, +1)) in device memory, through L1.
// From nfft 512 on, the N/16 threads of transform t (whole warps) run its
// groups alone, lane i taking groups i, i + N/16, ..., and meet between
// passes at a named barrier of their own, so the transforms of a batch do
// not wait for each other; below 512 points a warp would span transforms,
// and all 256 threads take the batch's groups as stockham_groups does
// (group v: transform v >> lg, group v mod 2^lg of it) and meet at
// __syncthreads.  A round trip ends at __syncthreads (the stage, or the
// span the FIR writes, is read across transforms next), and the FIR's
// first pass is followed by one too (its last pass writes span a
// neighbouring transform's first pass reads).
//
// The per-bin work between the transforms runs in registers.  After the
// forward's last pass, slot j of group q (of 2^lg = N/RS, RS = 2^rs) holds
// bin brev_rs(j) 2^lg + q, and group q of the inverse's first pass (stage
// 0) reads bins j 2^lg + q: the same bins, slot j' = brev_rs(j).  So the
// forward's last pass, the per-bin product and the inverse's first pass
// are one pass with no exchange and no barrier:
// - the FIR multiplies bin k by the tap spectrum hf[k];
// - the gate needs bins k and N - k of a frame pair (frames q and q+1 as
//   re/im of one transform), so a thread takes two mirror groups, q and
//   2^lg - q (slot j's mirror is slot RS-1-j of the other); groups 0 and
//   2^(lg-1) are each their own partner and go to unit 0.  It untangles A
//   = (Z[k] + conj Z[N-k])/2, B = (Z[k] - conj Z[N-k])/2i, masks each
//   against thr[min(k, N-k)], puts Y = ma A + i mb B back together at both
//   bins and runs the inverse's first pass on them.  With release > 0 the
//   mask of frame q depends on frame q-1's: the raw masks of a batch go to
//   shared memory, one thread per bin scans the batch's frames in order
//   (s = max(m_q, release s), s carried across batches), and each thread
//   reads its masks back; the points stay in registers across the two
//   barriers (16 a thread).
//
// Overlap-save: two blocks of the FIR's span as re/im of one transform (the
// taps are real), 2B blocks a batch; the filtered blocks overwrite the span
// in place (each batch reads all its blocks in its first pass, and the
// next batch's blocks start past this batch's outputs).  Gate: frames q,
// q+1 of transform t, 2B frames a batch, windowed as the first pass loads
// them; the inverse's last pass stores the windowed, 1/N-scaled frames of
// the batch into the first exchange buffer in natural order (the stage).
// Then one pass sums each output position's covering frames of the batch:
// position p of the batch (from its first frame's start) belongs to thread
// p mod 256, which adds the carry (the nfft-hop samples the frames before
// spilled past them) and the stage's frames, and writes the output sample
// if no later frame covers it (p < nf*hop, or the file's last frame is in
// the batch) or else the new carry.  No atomics; the carry alternates
// between two buffers.
//
// Shared memory (floats), in order: thr (N/2+1), rel (N/2+1), carry (2 (N-H)),
// span (regs_span), masks (2B (N/2+1), release > 0 only), then the tail:
// the two exchange buffers (4 * 256 R), which the kernel's fill may also use
// as scratch before the FIR starts (res_chain_kernel.cu: its phase bank and
// raw window).  kernels/gate_kernel.py (regs_geometry) sizes it in the
// same order.
//
// nfft 8192: one transform is 512 threads of 16 points (T = 512, B = 1,
// one CTA an SM), and two exchange buffers (128 KB) would leave no room
// for the span, so the CTA has one (kOne): every pass that reads and
// writes it loads all its groups into registers (R / RP a thread), meets
// the CTA, then stores; the gate's merged pass does the same with its
// units, and with release > 0 scans its two frames' masks in registers
// (the batch is one transform, so a bin's two frames are one thread's),
// with no masks buffer.  The span lives in device memory (span_rows, a
// row per CTA, mostly in L2): in shared memory beside the exchange buffer it
// held 1 to 3 hops, so each tile recomputed 3 halo frames and 2 FIR
// blocks a hop; in device memory the tiles are as long as at nfft 1024.
#pragma once

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace asp {

// Geometry, filled by chain_geo from the wrapper's arguments; the Python
// wrappers (kernels/gate_kernel.py, regs_geometry) size the dynamic shared
// memory from the same fields, in the order fir_gate_regs carves it.
struct ChainGeo {
  int nfft;       // N, a power of two
  int log2n;
  int hop;        // H, divides N
  int taps;       // T, T - 1 < N (1 for the gate alone)
  int nframes;    // F = 1 + (u - N) / H for an input u of the gate
  int out_len;    // N + (F - 1) * H, or a shard's length (shard_geo)
  int mf;         // frames per tile (>= 1)
  int tile;       // mf * H output samples per tile
  int d;          // N - H
  int r;          // N / H
  int blk;        // overlap-save block, N - (T - 1)
  int ntiles;     // ceil(out_len / tile)
  int sequential; // 1: one CTA per channel walks its tiles in order
  float thresh_gain;
  float att;
  float release;
  float inv_n;
};

inline ChainGeo chain_geo(int nfft, int log2n, int hop, int taps, int nframes,
                          int mf, int sequential, float thresh_gain, float att,
                          float release) {
  ChainGeo g;
  g.nfft = nfft;
  g.log2n = log2n;
  g.hop = hop;
  g.taps = taps;
  g.nframes = nframes;
  g.out_len = nfft + (nframes - 1) * hop;
  g.mf = mf;
  g.tile = mf * hop;
  g.d = nfft - hop;
  g.r = nfft / hop;
  g.blk = nfft - (taps - 1);
  g.ntiles = (g.out_len + g.tile - 1) / g.tile;
  g.sequential = sequential;
  g.thresh_gain = thresh_gain;
  g.att = att;
  g.release = release;
  g.inv_n = 1.0f / static_cast<float>(nfft);
  return g;
}

// The geometry of one time shard of the gate (gate_kernel.cu's
// asp_gate_shard): the first `nvalid` frames are computed, but the output
// covers `out_len` samples (the shard and its spill), zero past the frames.
inline ChainGeo shard_geo(ChainGeo g, int out_len) {
  g.out_len = out_len;
  g.ntiles = (out_len + g.tile - 1) / g.tile;
  return g;
}

// The 1/WOLA norm at output position p from tab = [head ramp (d) | one
// interior period (H) | tail ramp (d)] (hop a power of two); 1 where tab
// is null (an un-normalized shard).
__device__ __forceinline__ float inv_norm_at(const ChainGeo& g, const float* tab, int p) {
  if (tab == nullptr) return 1.0f;
  if (p < g.d) return tab[p];
  if (p >= g.out_len - g.d) return tab[g.d + g.hop + p - (g.out_len - g.d)];
  return tab[g.d + (p & (g.hop - 1))];
}

constexpr int kRegsThreads = 256;

// Threads of a CTA of the body at nfft: 256, or 512 for one transform of
// 8192 points (the one-buffer layout).
__host__ __device__ __forceinline__ constexpr int regs_threads(int nfft) {
  return nfft > 16 * kRegsThreads ? 2 * kRegsThreads : kRegsThreads;
}

// Points a thread holds in a full pass: 16, or the whole transform below 16.
__host__ __device__ __forceinline__ constexpr int regs_points(int nfft) {
  return nfft < 16 ? nfft : 16;
}

// Floats of the span a tile's frames read (the halo's too in the parallel
// launch); with the FIR (fir) in whole overlap-save blocks, plus the FIR
// history.
__host__ __device__ __forceinline__ int regs_span(const ChainGeo& g, bool fir) {
  const int halo = g.sequential ? 0 : g.r - 1;
  const int len = (g.mf + halo - 1) * g.hop + g.nfft;
  return fir ? (len + g.blk - 1) / g.blk * g.blk + g.taps - 1 : len;
}

// Floats of shared memory before the tail (the exchange buffers); T
// threads, the span and the masks buffer only with two exchange buffers
// (T = 256; at T = 512 the span is in device memory, span_rows).
template <int T = kRegsThreads>
__host__ __device__ __forceinline__ int regs_head_floats(const ChainGeo& g, bool fir) {
  const int nb = g.nfft / 2 + 1;
  const int nfb = 2 * T * regs_points(g.nfft) / g.nfft;
  return 2 * nb + 2 * g.d + (T == kRegsThreads ? regs_span(g, fir) : 0)
         + (g.sequential && T == kRegsThreads ? nfb * nb : 0);
}

// The threads that share the passes of transforms first .. first + count
// - 1: `size` of them, this one lane `lane`, meeting at named barrier `id`
// (the CTA's own barrier where size is the whole CTA).
struct Team {
  int first, count, lane, size, id;
  __device__ __forceinline__ void sync() const {
    if (size == kRegsThreads) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(size) : "memory");
    }
  }
};

// The CTA as the team of a batch of one transform (the overlap-save
// kernel's): it meets at __syncthreads alone.  A named barrier with a
// run-time id makes ptxas count all 16 of a CTA's, and the occupancy API
// then gives 64-thread CTAs of 128 registers 4 an SM instead of 8.
struct CtaTeam {
  int first, count, lane, size, id;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Transform t's N/R threads from 32 on (whole warps), else the CTA (T
// threads) on all nt transforms.
template <int T = kRegsThreads>
__device__ __forceinline__ Team regs_team(int log2n, int nt, int points) {
  const int g = (1 << log2n) / points;
  const int tid = threadIdx.x;
  if (g < 32) return Team{0, nt, tid, T, 0};
  const int t = tid / g;
  return Team{t, 1, tid - t * g, g, 1 + t};
}

// One pass of RP points a group from stage s0 over the team's transforms:
// group v (transform v >> lg, group v mod 2^lg of it) to lane v mod size.
// Indices are batch-local (t N + index); through pease_swizzle where
// swz_in / swz_out.  kHold (one exchange buffer, read and written by the
// pass): a lane's R / RP groups are all loaded before the team meets and
// any is stored.
template <int RP, bool kHold = false, int R = 16, class Load, class Store, class Tm>
__device__ __forceinline__ void regs_pass(int log2n, int s0, const Tm& tm, Load load,
                                          bool swz_in, Store store, bool swz_out,
                                          const float2* tw) {
  constexpr int rp = pass_bits(RP);
  const int lg = log2n - rp;
  int rsw[rp], wsw[rp];
  stockham_read_offsets<RP>(rsw, log2n, s0, swz_in);
  stockham_write_offsets<RP>(wsw, log2n, swz_out);
  if constexpr (kHold) {
    constexpr int G = R / RP;
    float2 x[G][RP];
    int wo[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      wo[i] = stockham_group<RP>(x[i], (tm.first << lg) + tm.lane + i * tm.size, log2n, s0,
                                 load, swz_in, rsw, tw);
    }
    tm.sync();
#pragma unroll
    for (int i = 0; i < G; ++i) stockham_put<RP>(x[i], wo[i], swz_out, wsw, store);
  } else {
    for (int v = (tm.first << lg) + tm.lane; v < (tm.first + tm.count) << lg; v += tm.size) {
      float2 x[RP];
      const int wo = stockham_group<RP>(x, v, log2n, s0, load, swz_in, rsw, tw);
      stockham_put<RP>(x, wo, swz_out, wsw, store);
    }
  }
}

// The inverse's first pass (stage 0) on the bins of forward group q (slot j
// holding bin brev(j) 2^lg + q), stored through `store`.
template <int RS, class Store>
__device__ __forceinline__ void inverse_first(const float2 (&x)[RS], int log2n, int t, int q,
                                              Store store, bool swz_out,
                                              const int (&wsw)[pass_bits(RS)],
                                              const float2* twi) {
  constexpr int rs = pass_bits(RS);
  float2 y[RS];
#pragma unroll
  for (int j = 0; j < RS; ++j) y[j] = x[brev_bits(j, rs)];
  stockham_pass<RS>(y, twi, 0, 0);
  stockham_put<RS>(y, (t << log2n) | q, swz_out, wsw, store);
}

// The FIR's merged pass: the forward's last pass from s0, the product with
// hf, the inverse's first pass.  kHold: every thread loads its group before
// any thread stores (a one-pass transform reads and writes the span).
// kOne (one exchange buffer): a lane's R / RS groups are all loaded before
// the team meets and any is stored.
template <int RS, bool kHold, bool kOne = false, int R = 16, class Load, class Store, class Tm>
__device__ __forceinline__ void fir_middle(int log2n, int s0, const Tm& tm, Load load,
                                           bool swz_in, Store store, bool swz_out,
                                           const float2* twf, const float2* twi,
                                           const float2* __restrict__ hf) {
  constexpr int rs = pass_bits(RS);
  const int lg = log2n - rs;
  int rsw[rs], wsw[rs];
  stockham_read_offsets<RS>(rsw, log2n, s0, swz_in);
  stockham_write_offsets<RS>(wsw, log2n, swz_out);
  if constexpr (kOne) {
    constexpr int G = R / RS;
    float2 x[G][RS];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int v = (tm.first << lg) + tm.lane + i * tm.size, q = v & ((1 << lg) - 1);
      stockham_group<RS>(x[i], v, log2n, s0, load, swz_in, rsw, twf);
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        x[i][j] = cmul(x[i][j], __ldg(hf + ((brev_bits(j, rs) << lg) | q)));
      }
    }
    tm.sync();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int v = (tm.first << lg) + tm.lane + i * tm.size;
      inverse_first<RS>(x[i], log2n, v >> lg, v & ((1 << lg) - 1), store, swz_out, wsw, twi);
    }
    return;
  }
  for (int v = (tm.first << lg) + tm.lane; v < (tm.first + tm.count) << lg; v += tm.size) {
    const int t = v >> lg, q = v & ((1 << lg) - 1);
    float2 x[RS];
    stockham_group<RS>(x, v, log2n, s0, load, swz_in, rsw, twf);
#pragma unroll
    for (int j = 0; j < RS; ++j) x[j] = cmul(x[j], __ldg(hf + ((brev_bits(j, rs) << lg) | q)));
    if constexpr (kHold) __syncthreads();
    inverse_first<RS>(x, log2n, t, q, store, swz_out, wsw, twi);
  }
}

// Every bin pair (k, N-k) of unit u's groups (z: group u, or 0 for u = 0;
// y: group 2^lg - u, or 2^(lg-1) for u = 0; y unused where lg = 0), once:
// f(Z[k], Z[N-k], k), the two references equal where k = N-k.
template <int RS, class F>
__device__ __forceinline__ void for_bin_pairs(float2 (&z)[RS], float2 (&y)[RS], int u, int lg,
                                              F&& f) {
  constexpr int rs = pass_bits(RS);
  if (u != 0) {
#pragma unroll
    for (int j = 0; j < RS; ++j) f(z[j], y[RS - 1 - j], (brev_bits(j, rs) << lg) + u);
    return;
  }
#pragma unroll
  for (int j = 0; j < RS; ++j) {  // group 0: bin b 2^lg mirrors (RS - b) 2^lg
    const int b = brev_bits(j, rs);
    if (b > RS / 2) continue;
    f(z[j], z[brev_bits((RS - b) & (RS - 1), rs)], b << lg);
  }
  if (lg == 0) return;
#pragma unroll
  for (int j = 0; j < RS / 2; ++j) {  // group 2^(lg-1): slot j mirrors slot RS-1-j
    f(y[j], y[RS - 1 - j], (brev_bits(j, rs) << lg) + (1 << (lg - 1)));
  }
}

// The gate's merged pass on a batch of nf frames (frames 2t and 2t + 1 of
// the batch in transform t): the forward's last pass from s0, untangle,
// mask, retangle, the inverse's first pass.  A transform has 2^(lg-1)
// units (1 where lg = 0), each two mirror groups; lane i of the team takes
// its units i + size k, kUnits of them: one at a time, or with kRelease
// (the masks scanned along the frames) all at once, their points held in
// registers across the scan's barriers.  kOne (one exchange buffer, one
// transform a batch, T threads): all at once, the team meeting between the
// loads and the stores, the release scan of the two frames in registers.
template <int R, int RS, bool kRelease, bool kOne = false, int T = kRegsThreads, class Load,
          class Store>
__device__ __forceinline__ void gate_middle(const ChainGeo& g, int s0, const Team& tm, Load load,
                                            bool swz_in, Store store, bool swz_out,
                                            const float2* twf, const float2* twi,
                                            const float* thr, float* masks, float* rel, int nf) {
  constexpr int rs = pass_bits(RS);
  constexpr int kUnits = R == RS ? 1 : 8 / RS;
  const int log2n = g.log2n, n = 1 << log2n, lg = log2n - rs, nb = n / 2 + 1;
  const int lu = lg > 0 ? lg - 1 : 0;  // log2 of the units a transform
  int rsw[rs], wsw[rs];
  stockham_read_offsets<RS>(rsw, log2n, s0, swz_in);
  stockham_write_offsets<RS>(wsw, log2n, swz_out);
  const int w0 = (tm.first << lu) + tm.lane;
  const float att = g.att;
  // unit i's transform t holds frames 2t (A, the real part) and 2t + 1 (B)
  const auto frames = [lu, w0, &tm](int i) { return 2 * ((w0 + i * tm.size) >> lu); };
  const auto unit = [lu, w0, &tm](int i) { return (w0 + i * tm.size) & ((1 << lu) - 1); };
  const auto mirror = [lg](int u) { return u == 0 ? (lg > 0 ? 1 << (lg - 1) : 0) : (1 << lg) - u; };
  const auto load_unit = [&](int i, float2 (&z)[RS], float2 (&y)[RS]) {
    const int t = frames(i) / 2, u = unit(i);
    stockham_group<RS>(z, (t << lg) | u, log2n, s0, load, swz_in, rsw, twf);
    if (lg > 0) stockham_group<RS>(y, (t << lg) | mirror(u), log2n, s0, load, swz_in, rsw, twf);
  };
  const auto store_unit = [&](int i, const float2 (&z)[RS], const float2 (&y)[RS]) {
    const int t = frames(i) / 2, u = unit(i);
    inverse_first<RS>(z, log2n, t, u, store, swz_out, wsw, twi);
    if (lg > 0) inverse_first<RS>(y, log2n, t, mirror(u), store, swz_out, wsw, twi);
  };
  // Y = ma*A + i*mb*B at k, and its Hermitian partner at N-k, with
  // A = (Z[k] + conj Z[N-k])/2, B = (Z[k] - conj Z[N-k])/2i
  const auto gate = [](float2& zk, float2& zn, float ma, float mb) {
    const float ar = 0.5f * (zk.x + zn.x), ai = 0.5f * (zk.y - zn.y);
    const float br = 0.5f * (zk.y + zn.y), bi = -0.5f * (zk.x - zn.x);
    zk = make_float2(ma * ar - mb * bi, ma * ai + mb * br);
    zn = make_float2(ma * ar + mb * bi, mb * br - ma * ai);
  };
  // the raw masks of a pair's frames: |A| and |B| against thr
  const auto raw = [att](const float2& zk, const float2& zn, float th, float& ma, float& mb) {
    const float ar = 0.5f * (zk.x + zn.x), ai = 0.5f * (zk.y - zn.y);
    const float br = 0.5f * (zk.y + zn.y), bi = -0.5f * (zk.x - zn.x);
    ma = sqrtf(ar * ar + ai * ai) > th ? 1.0f : att;
    mb = sqrtf(br * br + bi * bi) > th ? 1.0f : att;
  };
  if constexpr (kOne) {
    float2 z[kUnits][RS], y[kUnits][RS];
#pragma unroll
    for (int i = 0; i < kUnits; ++i) load_unit(i, z[i], y[i]);
    tm.sync();
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      for_bin_pairs<RS>(z[i], y[i], unit(i), lg, [&](float2& zk, float2& zn, int k) {
        const int kk = min(k, n - k);
        float ma, mb;
        raw(zk, zn, thr[kk], ma, mb);
        if constexpr (kRelease) {  // frames 0 and 1 of the batch, in order
          ma = fmaxf(ma, g.release * rel[kk]);
          if (nf > 1) mb = fmaxf(mb, g.release * ma);
          rel[kk] = nf > 1 ? mb : ma;
        }
        gate(zk, zn, ma, nf > 1 ? mb : 0.0f);
      });
      store_unit(i, z[i], y[i]);
    }
  } else if constexpr (!kRelease) {
#pragma unroll 1
    for (int i = 0; i < kUnits; ++i) {
      float2 z[RS], y[RS];
      load_unit(i, z, y);
      const int fa = frames(i);
      for_bin_pairs<RS>(z, y, unit(i), lg, [&](float2& zk, float2& zn, int k) {
        float ma, mb;
        raw(zk, zn, thr[min(k, n - k)], ma, mb);
        gate(zk, zn, fa < nf ? ma : 0.0f, fa + 1 < nf ? mb : 0.0f);
      });
      store_unit(i, z, y);
    }
  } else {
    float2 z[kUnits][RS], y[kUnits][RS];
#pragma unroll
    for (int i = 0; i < kUnits; ++i) load_unit(i, z[i], y[i]);
    // raw masks to shared memory, a scan along the batch's frames, back
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int fa = frames(i);
      for_bin_pairs<RS>(z[i], y[i], unit(i), lg, [&](float2& zk, float2& zn, int k) {
        const int kk = min(k, n - k);
        float ma, mb;
        raw(zk, zn, thr[kk], ma, mb);
        if (fa < nf) masks[fa * nb + kk] = ma;
        if (fa + 1 < nf) masks[(fa + 1) * nb + kk] = mb;
      });
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nb; k += T) {
      float s = rel[k];
      for (int f = 0; f < nf; ++f) {
        s = fmaxf(masks[f * nb + k], g.release * s);
        masks[f * nb + k] = s;
      }
      rel[k] = s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int fa = frames(i);
      for_bin_pairs<RS>(z[i], y[i], unit(i), lg, [&](float2& zk, float2& zn, int k) {
        const int kk = min(k, n - k);
        gate(zk, zn, fa < nf ? masks[fa * nb + kk] : 0.0f,
             fa + 1 < nf ? masks[(fa + 1) * nb + kk] : 0.0f);
      });
      store_unit(i, z[i], y[i]);
    }
  }
}

// A forward and inverse transform of the batch around a merged middle pass
// (mid(s0, load, swz_in, store, swz_out)): the first pass reads through
// `first`, the last writes through `last`, the passes between cross the
// exchange buffers ex0, ex1 (planes of `cap` floats), pass p writing
// ex[p mod 2], the team meeting between passes (the CTA after the first
// where kFullFirst).  The plan has an odd number of passes, so a stage
// written to ex0 by `last` is not the buffer the last pass reads.  kOne:
// one buffer, ex0, read and written by every pass after the first, each
// holding its groups across a meeting of the team (the middle's own).
// Returns after a __syncthreads().
template <int R, int RS, bool kFullFirst, bool kOne = false, class First, class Mid,
          class Last, class Tm>
__device__ __forceinline__ void regs_round_trip(int log2n, const Tm& tm, float* ex, int cap,
                                                First first, Mid mid, Last last,
                                                const float2* twf, const float2* twi) {
  if constexpr (R == RS) {  // one pass each way: nfft <= 16
    mid(0, first, false, last, false);
    __syncthreads();
    return;
  } else {
    constexpr int rs = pass_bits(RS);
    constexpr int kBuf = kOne ? 0 : 1;
    const auto in = [ex, cap](int p) {
      return PlanarIn{ex + (p & kBuf) * 2 * cap, ex + (p & kBuf) * 2 * cap + cap};
    };
    const auto out = [ex, cap](int p) {
      return PlanarOut{ex + (p & kBuf) * 2 * cap, ex + (p & kBuf) * 2 * cap + cap};
    };
    const bool mid3 = (log2n - rs) % 4 == 3;
    int s0, p = 0;
    if (mid3) {
      regs_pass<8>(log2n, 0, tm, first, false, out(p), true, twf);
      s0 = 3;
    } else {
      regs_pass<16>(log2n, 0, tm, first, false, out(p), true, twf);
      s0 = 4;
    }
    if (kFullFirst) {
      __syncthreads();
    } else {
      tm.sync();
    }
    for (; s0 < log2n - rs; s0 += 4) {
      ++p;
      regs_pass<16, kOne, R>(log2n, s0, tm, in(p - 1), true, out(p), true, twf);
      tm.sync();
    }
    ++p;
    mid(s0, in(p - 1), true, out(p), true);
    tm.sync();
    s0 = rs;
    if (mid3) {
      ++p;
      regs_pass<8, kOne, R>(log2n, s0, tm, in(p - 1), true, out(p), true, twi);
      tm.sync();
      s0 += 3;
    }
    for (; s0 + 4 < log2n; s0 += 4) {
      ++p;
      regs_pass<16, kOne, R>(log2n, s0, tm, in(p - 1), true, out(p), true, twi);
      tm.sync();
    }
    regs_pass<16, kOne, R>(log2n, s0, tm, in(p), true, last, false, twi);
    __syncthreads();
  }
}

// The tiles of channel c that this CTA owns (blockIdx.x, step gridDim.x),
// written to oc; kRelease: g.release > 0 (the sequential launch); kFir
// false: the gate alone (g.taps 1, hf unused).  fill(span, s, len,
// scratch): every thread calls it; it stores the FIR input (kFir false:
// the gate's input) u[s + i] in span[i] for i < len (zero where s + i < 0
// or past the end of u), may use `scratch` (the exchange buffers) and
// returns after a __syncthreads().  twf / twi: stockham_table(N, -1) and
// (N, +1); hf: the N-point spectrum of the zero-padded taps; inv_tab: the
// 1/WOLA table (inv_norm_at), or null for the un-normalized overlap-add;
// span_rows: with one exchange buffer (T = 512) the CTAs' spans in device
// memory, a row of regs_span floats per CTA (blockIdx.y * gridDim.x +
// blockIdx.x), unused below.
template <int R, int RS, bool kRelease, bool kFir, int T = kRegsThreads, class Fill>
__device__ void fir_gate_regs(const ChainGeo& g, float* smem, int c, float* __restrict__ oc,
                              const float* __restrict__ noise_floor,
                              const float* __restrict__ win,
                              const float2* __restrict__ hf,
                              const float2* __restrict__ twf,
                              const float2* __restrict__ twi,
                              const float* __restrict__ inv_tab, float* span_rows,
                              const Fill& fill) {
  constexpr bool kOne = T > kRegsThreads;  // one exchange buffer
  const int N = g.nfft, L = g.log2n, H = g.hop, nb = N / 2 + 1;
  const int cap = T * R;  // complex points of a batch
  const int B = cap >> L, nfb = 2 * B;
  const int tid = threadIdx.x;
  const int lh = __ffs(H) - 1;  // log2 hop
  const Team tm = regs_team<T>(L, B, R);
  // the end of the last frame: positions past it (a shard's) are 0
  const int frames_end = g.nframes > 0 ? N + (g.nframes - 1) * H : 0;
  float* thr = smem;
  float* rel = thr + nb;
  float* carry = rel + nb;  // two buffers of d
  // the span: shared memory, or with one exchange buffer this CTA's row of
  // span_rows in device memory (L2), which leaves room for long tiles
  float* span = kOne ? span_rows + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)
                                       * regs_span(g, kFir)
                     : carry + 2 * g.d;
  float* masks = kOne ? nullptr : span + regs_span(g, kFir);
  float* ex = smem + regs_head_floats<T>(g, kFir);
  float* stage_re = ex;
  float* stage_im = ex + cap;

  for (int k = tid; k < nb; k += T) {
    thr[k] = noise_floor[static_cast<size_t>(c) * nb + k] * g.thresh_gain;
    rel[k] = 0.0f;
  }
  for (int i = tid; i < g.d; i += T) carry[i] = 0.0f;
  int cur = 0;  // the carry buffer the next batch reads
  __syncthreads();

  for (int j = blockIdx.x; j < g.ntiles; j += gridDim.x) {
    const int ts = j * g.tile;
    int qa = j * g.mf - (g.sequential ? 0 : g.r - 1);
    qa = qa < 0 ? 0 : qa;
    const int qb = min((j + 1) * g.mf, g.nframes);
    // output positions this tile writes: all of them when one CTA walks
    // the channel, else the tile's own
    const int lo = g.sequential ? 0 : ts;
    const int hi = g.sequential ? g.out_len : min(ts + g.tile, g.out_len);
    if (!g.sequential) {
      for (int i = tid; i < g.d; i += T) carry[cur * g.d + i] = 0.0f;
    }
    for (int gp = max(ts, frames_end) + tid; gp < min(ts + g.tile, g.out_len); gp += T) {
      oc[gp] = 0.0f;
    }
    if (qb <= qa) continue;
    // ---- FIR: span[m] ends up holding the filtered y[y0 + m]; without
    // it, the gate's input
    const int y0 = qa * H;
    const int len = (qb - 1) * H + N - y0;
    if constexpr (!kFir) {
      fill(span, y0, len, ex);
    } else {
      const int nblk = (len + g.blk - 1) / g.blk;
      fill(span, y0 - (g.taps - 1), nblk * g.blk + g.taps - 1, ex);
      for (int k0 = 0; k0 < nblk; k0 += 2 * B) {
        // transform t (index i >> L) takes blocks k0 + 2t (re) and k0 + 2t + 1 (im)
        const auto load = [span, &g, k0, nblk, L, N](int i) {
          const int kb = k0 + 2 * (i >> L), o = kb * g.blk + (i & (N - 1));
          return make_float2(kb < nblk ? span[o] : 0.0f,
                             kb + 1 < nblk ? span[o + g.blk] : 0.0f);
        };
        const auto store = [span, &g, k0, nblk, L, N](int i, float2 v) {
          const int kb = k0 + 2 * (i >> L), o = (i & (N - 1)) - (g.taps - 1);
          if (o < 0) return;
          if (kb < nblk) span[kb * g.blk + o] = v.x * g.inv_n;
          if (kb + 1 < nblk) span[(kb + 1) * g.blk + o] = v.y * g.inv_n;
        };
        const auto mid = [&](int s0, auto ld, bool si, auto st, bool so) {
          fir_middle<RS, R == RS, kOne, R>(L, s0, tm, ld, si, st, so, twf, twi, hf);
        };
        regs_round_trip<R, RS, true, kOne>(L, tm, ex, cap, load, mid, store, twf, twi);
      }
    }
    // ---- gate: a batch of frames q0 .. q0 + nf - 1, frames q0 + 2t and
    // q0 + 2t + 1 as re/im of transform t
    for (int q0 = qa; q0 < qb; q0 += nfb) {
      const int nf = min(nfb, qb - q0);
      const float* f0 = span + (q0 - qa) * H;
      const auto load = [f0, win, nf, H, L, N](int i) {
        const int fa = 2 * (i >> L), k = i & (N - 1);
        const float w = __ldg(win + k);
        const float* a = f0 + fa * H + k;
        return make_float2(fa < nf ? a[0] * w : 0.0f, fa + 1 < nf ? a[H] * w : 0.0f);
      };
      const auto store = [stage_re, stage_im, win, &g, N](int i, float2 v) {
        const float w = __ldg(win + (i & (N - 1))) * g.inv_n;
        stage_re[i] = v.x * w;
        stage_im[i] = v.y * w;
      };
      const auto mid = [&](int s0, auto ld, bool si, auto st, bool so) {
        gate_middle<R, RS, kRelease, kOne, T>(g, s0, tm, ld, si, st, so, twf, twi, thr, masks,
                                              rel, nf);
      };
      regs_round_trip<R, RS, false, kOne>(L, tm, ex, cap, load, mid, store, twf, twi);
      // ---- overlap-add: position p of the batch (from q0's start) is
      // thread p mod T's; frame f of the batch is stage (f odd ? im : re)
      // of transform f/2
      const float* cin = carry + cur * g.d;
      float* cout = carry + (cur ^ 1) * g.d;
      const int fin = nf * H;
      const bool end = q0 + nf == g.nframes;
      for (int p = tid; p < fin + g.d; p += T) {
        // frames f of the batch with f H <= p < f H + N (hop and nfft are
        // powers of two: shifts, no division)
        float v = p < g.d ? cin[p] : 0.0f;
        const int k = p >> lh;
        const int f_hi = min(nf - 1, k);
        for (int f = max(0, k - g.r + 1); f <= f_hi; ++f) {
          v += ((f & 1) ? stage_im : stage_re)[(f >> 1) * N + p - (f << lh)];
        }
        if (p < fin || end) {
          const int gp = q0 * H + p;
          if (gp >= lo && gp < hi) oc[gp] = v * inv_norm_at(g, inv_tab, gp);
        } else {
          cout[p - fin] = v;
        }
      }
      cur ^= 1;
      __syncthreads();
    }
  }
}

// The overlap-save FIR of os_kernel.cu, on the same round trip: row c of y
// (n samples) is the causal FIR of row c of x (n samples, stride x_ld)
// with the taps - 1 samples of row c of hist before it (zeros where hist
// is null).  A unit is one transform, blocks 2p and 2p + 1 of a channel
// (blk = N - (taps - 1) outputs each, from raw samples [k blk, k blk + N)
// of [hist | x]) as re/im; units are numbered across channels (u = c npair
// + p), and a CTA takes the B = T R / N units of one batch from blockIdx.x
// B on.
struct OsGeo {
  int n, x_ld, taps, blk, nblk, npair, units;
};

// The CTA's batch: the first pass reads the raw samples straight from
// device memory (neighbouring groups, neighbouring addresses; zero past
// the end of x, a null hist as zeros), the merged pass multiplies by hf,
// the inverse's last pass drops each block's first taps - 1 points and
// stores the rest, scaled by 1/N, straight to y.  kOne: one exchange
// buffer (nfft 8192 and 16384, one transform a batch).  kSolo: a batch of
// one transform (N = T R), its team the CTA (CtaTeam).  smem: the
// exchange buffers (planes of T R floats), then B int4 (the units' channel,
// first raw sample, second block, valid).
template <int R, int RS, int T, bool kOne, bool kSolo>
__device__ void os_regs(const OsGeo& g, int log2n, float* smem, const float* __restrict__ x,
                        const float* __restrict__ hist, float* __restrict__ y,
                        const float2* __restrict__ hf, const float2* __restrict__ twf,
                        const float2* __restrict__ twi) {
  const int L = log2n, N = 1 << L, B = (T * R) >> L, hl = g.taps - 1;
  float* ex = smem;
  int4* unit = reinterpret_cast<int4*>(smem + (kOne ? 2 : 4) * T * R);
  for (int t = threadIdx.x; t < B; t += T) {
    const int u = blockIdx.x * B + t;
    const int c = u / g.npair, k = 2 * (u - c * g.npair);
    unit[t] = make_int4(c, k * g.blk, k + 1 < g.nblk, u < g.units);
  }
  __syncthreads();
  const float inv_n = 1.0f / static_cast<float>(N);
  // raw sample j of channel c: [hist (hl) | x (n)], zero past the end
  const auto raw = [=, &g](int c, int j) {
    if (j < hl) return hist != nullptr ? hist[static_cast<size_t>(c) * hl + j] : 0.0f;
    j -= hl;
    return j < g.n ? x[static_cast<size_t>(c) * g.x_ld + j] : 0.0f;
  };
  const auto load = [=, &g](int i) {
    const int4 e = unit[i >> L];
    const int j = e.y + (i & (N - 1));
    if (!e.w) return make_float2(0.0f, 0.0f);
    return make_float2(raw(e.x, j), e.z ? raw(e.x, j + g.blk) : 0.0f);
  };
  const auto store = [=, &g](int i, float2 v) {
    const int4 e = unit[i >> L];
    const int k = (i & (N - 1)) - hl;  // output k of the unit's first block
    if (!e.w || k < 0) return;
    const int o = e.y + k;
    float* yc = y + static_cast<size_t>(e.x) * g.n;
    if (o < g.n) yc[o] = v.x * inv_n;
    if (e.z && o + g.blk < g.n) yc[o + g.blk] = v.y * inv_n;
  };
  const auto trip = [&](const auto& tm) {
    const auto mid = [&](int s0, auto ld, bool si, auto st, bool so) {
      fir_middle<RS, false, kOne, R>(L, s0, tm, ld, si, st, so, twf, twi, hf);
    };
    regs_round_trip<R, RS, false, kOne>(L, tm, ex, T * R, load, mid, store, twf, twi);
  };
  if constexpr (kSolo) {
    trip(CtaTeam{0, 1, static_cast<int>(threadIdx.x), T, 0});
  } else {
    trip(regs_team<T>(L, B, R));
  }
}

// The launch's kernel for nfft, from a kernel template K<R, RS, kRelease,
// T> (a class whose static fn() returns the __global__ function): one pass
// each way below 32 points, else passes of 16 points a group and the
// merged pass of 2^(log2 nfft mod 4) points (2 where that is 0), as
// regs_pass_plan (kernels/gate_kernel.py) plans them, on regs_threads(nfft)
// threads; the sequential (release > 0) launch's own.
template <template <int, int, bool, int> class K, bool kRelease>
auto regs_kernel_for(int nfft) {
  constexpr int T = kRegsThreads;
  const int rs = __builtin_ctz(static_cast<unsigned>(nfft)) % 4;
  return nfft == 2 ? K<2, 2, kRelease, T>::fn()
         : nfft == 4 ? K<4, 4, kRelease, T>::fn()
         : nfft == 8 ? K<8, 8, kRelease, T>::fn()
         : nfft == 16 ? K<16, 16, kRelease, T>::fn()
         : nfft == 32 * T ? K<16, 2, kRelease, 2 * T>::fn()
         : rs == 2 ? K<16, 4, kRelease, T>::fn()
         : rs == 3 ? K<16, 8, kRelease, T>::fn()
                   : K<16, 2, kRelease, T>::fn();
}

template <template <int, int, bool, int> class K>
auto regs_kernel_for(int nfft, int sequential) {
  return sequential ? regs_kernel_for<K, true>(nfft) : regs_kernel_for<K, false>(nfft);
}

// A built kernel of `threads` threads at smem_bytes of dynamic shared
// memory: info = {registers a thread, local memory bytes a thread (spills),
// resident CTAs an SM}.
template <class Kernel>
int regs_kernel_info(Kernel kernel, int threads, int smem_bytes, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[2], kernel, threads, smem_bytes));
}

}  // namespace asp
