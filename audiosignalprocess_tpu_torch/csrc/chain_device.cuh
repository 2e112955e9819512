// The whole-file FIR -> spectral noise gate body for Hopper (sm_90a):
// what chain_kernel.cu, res_chain_kernel.cu and gate_kernel.cu share.  The
// first two differ only in where the FIR's input comes from (the raw
// samples, or the resampled stream), which each kernel passes in as a
// `fill` functor; gate_kernel.cu runs the gate alone (kFir false).
//
// Per channel the body computes oracle.noise_gate(oracle.fir_direct(u, h),
// nfft, hop, ...) of its input u: causal FIR with zero history by FFT
// overlap-save, then frames at k*hop, periodic window, forward FFT, a hard
// per-bin mask against the noise floor (an input, computed by the wrapper),
// optional max-with-decay release along frames, inverse FFT, window,
// overlap-add, times the clamped 1/WOLA norm.
//
// Schedule (see chain_kernel.cu): with release == 0, one CTA per (channel,
// tile of MF hops of output) recomputes the halo its tile needs (the
// nfft/hop-1 frames before it and the FIR history before those); with
// release > 0, one CTA per channel walks its tiles in order, carrying the
// OLA spill and the release state in shared memory.
#pragma once

#include <cuda_runtime.h>

#include "fir_device.cuh"

namespace asp {

// Geometry, filled by chain_geo from the wrapper's arguments; the Python
// wrappers (kernels/chain_kernel.py, _geometry) size the dynamic shared
// memory from the same fields, in the order fir_gate_tiles carves it.
struct ChainGeo {
  int nfft;       // N, a power of two
  int log2n;
  int hop;        // H, divides N
  int taps;       // T, T - 1 < N
  int nframes;    // F = 1 + (u - N) / H for an input u of the gate
  int out_len;    // N + (F - 1) * H
  int mf;         // frames per tile (>= N / H)
  int tile;       // mf * H output samples per tile
  int d;          // N - H
  int r;          // N / H
  int blk;        // overlap-save block, N - (T - 1)
  int span;       // the longest FIR span of a tile (its frames, halo, history)
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
  // the parallel launch's tiles filter tile + 2d samples (their frames and
  // the halo frames), in whole overlap-save blocks, plus the FIR history
  g.span = (g.tile + 2 * g.d + g.blk - 1) / g.blk * g.blk + taps - 1;
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

// Floats of shared memory fir_gate_tiles uses: twiddles (N/2 complex),
// FFT buffer (N complex), threshold and release state (N/2+1 each), OLA
// tile (tile + d), FIR span.  A kernel's own shared memory follows.
__host__ __device__ __forceinline__ int chain_smem_floats(const ChainGeo& g) {
  return g.nfft + 2 * g.nfft + 2 * (g.nfft / 2 + 1) + g.tile + g.d + g.span;
}

__device__ __forceinline__ float inv_norm_at(const ChainGeo& g, const float* tab, int p) {
  // tab = [head ramp (d) | one interior period (H) | tail ramp (d)]
  if (p < g.d) return tab[p];
  if (p >= g.out_len - g.d) return tab[g.d + g.hop + p - (g.out_len - g.d)];
  return tab[g.d + p % g.hop];
}

// The tiles of channel c that this CTA owns (blockIdx.x, step gridDim.x),
// written to oc.  fill(span, s, len): every thread calls it; it stores
// the FIR input u[s + i] in span[i] for i < len (zero where s + i < 0 or
// past the end of u) and returns after a __syncthreads().  With kFir
// false there is no FIR (the gate alone, gate_kernel.cu): fill stores the
// gate's input itself, g.taps is 1 and hf is unused.  With inv_tab null
// the tiles are emitted un-normalized (one time shard of the gate, whose
// caller divides by the WOLA norm at global positions).
template <bool kFir = true, class Fill>
__device__ void fir_gate_tiles(const ChainGeo& g, float* smem, int c, float* __restrict__ oc,
                               const float* __restrict__ noise_floor,
                               const float* __restrict__ win,
                               const float2* __restrict__ hf,
                               const float2* __restrict__ tw,
                               const float* __restrict__ inv_tab, const Fill& fill) {
  const int N = g.nfft, H = g.hop;
  const int nb = N / 2 + 1;
  float2* tw_s = reinterpret_cast<float2*>(smem);  // N/2
  float2* z = tw_s + N / 2;                        // N, the FFT buffer
  float* thr = reinterpret_cast<float*>(z + N);    // nb, floor * gain
  float* rel = thr + nb;                           // nb, release state
  float* acc = rel + nb;                           // tile + d, OLA
  float* span = acc + g.tile + g.d;                // input -> filtered span

  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < N / 2; i += nt) tw_s[i] = tw[i];
  for (int k = tid; k < nb; k += nt) {
    thr[k] = noise_floor[static_cast<size_t>(c) * nb + k] * g.thresh_gain;
    rel[k] = 0.0f;
  }
  for (int i = tid; i < g.tile + g.d; i += nt) acc[i] = 0.0f;
  __syncthreads();

  for (int j = blockIdx.x; j < g.ntiles; j += gridDim.x) {
    const int ts = j * g.tile;  // first output sample of the tile
    // frames [qa, qb): the tile's own MF frames, and in the parallel
    // launch also the r-1 earlier frames that overlap into the tile
    int qa = j * g.mf - (g.sequential ? 0 : g.r - 1);
    qa = qa < 0 ? 0 : qa;
    const int qb = min((j + 1) * g.mf, g.nframes);
    if (qb > qa) {
      // ---- FIR: filtered y[y0 + m], m < len, by overlap-save.  span[r]
      // holds u[y0 - (T-1) + r]; block k reads span[k*blk, +N) and its
      // filtered output overwrites span[k*blk, +blk), which no later block
      // reads, so span[m] ends up holding y[y0 + m].
      const int y0 = qa * H;
      const int len = (qb - 1) * H + N - y0;
      if constexpr (kFir) {
        const int nblk = (len + g.blk - 1) / g.blk;
        fill(span, y0 - (g.taps - 1), nblk * g.blk + g.taps - 1);
        const auto raw = [span](int j) { return span[j]; };
        for (int k = 0; k < nblk; k += 2) {
          const bool two = k + 1 < nblk;
          os_block_pair(z, raw, k, two, g.blk, N, g.log2n, hf, tw_s);
          float* o = span + k * g.blk;
          for (int i = tid; i < g.blk; i += nt) {
            const float2 v = z[g.taps - 1 + i];
            o[i] = v.x * g.inv_n;
            if (two) o[g.blk + i] = v.y * g.inv_n;
          }
          __syncthreads();
        }
      } else {
        fill(span, y0, len);
      }
      // ---- gate: frames q, q+1 as re/im of one transform
      for (int q = qa; q < qb; q += 2) {
        const bool two = q + 1 < qb;
        const float* f = span + (q * H - y0);
        for (int i = tid; i < N; i += nt) {
          const float w = win[i];
          z[i] = make_float2(f[i] * w, two ? f[H + i] * w : 0.0f);
        }
        __syncthreads();
        fft_shared(z, N, g.log2n, false, tw_s);
        for (int k = tid; k < nb; k += nt) {
          const int k2 = (N - k) & (N - 1);
          const float2 zk = z[k];
          const float2 zn = z[k2];
          // A = (Z[k] + conj Z[N-k]) / 2, B = (Z[k] - conj Z[N-k]) / 2i
          const float ar = 0.5f * (zk.x + zn.x), ai = 0.5f * (zk.y - zn.y);
          const float br = 0.5f * (zk.y + zn.y), bi = -0.5f * (zk.x - zn.x);
          const float th = thr[k];
          float ma = sqrtf(ar * ar + ai * ai) > th ? 1.0f : g.att;
          float mb = 0.0f;
          if (two) mb = sqrtf(br * br + bi * bi) > th ? 1.0f : g.att;
          if (g.release > 0.0f) {
            ma = fmaxf(ma, g.release * rel[k]);
            if (two) mb = fmaxf(mb, g.release * ma);
            rel[k] = two ? mb : ma;
          }
          // Y = ma*A + i*mb*B at k, and its Hermitian partner at N-k
          z[k] = make_float2(ma * ar - mb * bi, ma * ai + mb * br);
          if (k2 != k) z[k2] = make_float2(ma * ar + mb * bi, mb * br - ma * ai);
        }
        __syncthreads();
        fft_shared(z, N, g.log2n, true, tw_s);
        // overlap-add: each thread owns output positions, adding frame q
        // (re) and frame q+1 (im, one hop later) where they cover it
        const int pa = q * H - ts;
        const int span_out = two ? N + H : N;
        for (int u = tid; u < span_out; u += nt) {
          const int p = pa + u;
          if (p < 0 || p >= g.tile + g.d) continue;
          float v = 0.0f;
          if (u < N) v += z[u].x * win[u];
          if (two && u >= H) v += z[u - H].y * win[u - H];
          acc[p] += v * g.inv_n;
        }
        __syncthreads();
      }
    }
    // ---- emit the tile, normalized
    for (int p = tid; p < g.tile; p += nt) {
      const int gp = ts + p;
      if (gp < g.out_len) oc[gp] = inv_tab ? acc[p] * inv_norm_at(g, inv_tab, gp) : acc[p];
    }
    __syncthreads();
    if (g.sequential) {
      // the spill past the tile becomes the head of the next one
      // (tile >= nfft > d, so source and destination do not overlap)
      for (int i = tid; i < g.d; i += nt) acc[i] = acc[g.tile + i];
      __syncthreads();
      for (int i = g.d + tid; i < g.tile + g.d; i += nt) acc[i] = 0.0f;
    } else {
      for (int i = tid; i < g.tile + g.d; i += nt) acc[i] = 0.0f;
    }
    __syncthreads();
  }
}

}  // namespace asp
