// The streaming FIR -> noise-gate (-> envelope) step on batched register
// Stockham transforms, for Hopper (sm_90a): the device body that
// fir_gate_step_kernel.cu, res_fir_gate_step_kernel.cu and
// gate_step_kernel.cu share.  The first two differ only in where the FIR's
// input comes from (the raw block, or the block resampled in the CTA),
// which each kernel passes in as a `fill` functor, as the whole-file
// kernels do (chain_regs_device.cuh); the gate step runs it with kFir
// false, which leaves the FIR out (the fill then stores the gate's input,
// and the span is [in_tail | x] of the segment's frames).
//
// Per channel and block it computes the JAX package's plain composition
// FIRStage(h, nfft).step -> GateStage.step [-> FIRStage(env_h, pre="abs",
// post_scale=env_scale).step] with the plain path's carry: FIR history,
// the gate dict (in_tail, planar spectral FIFO of nf frames, per-bin floor
// sum, OLA tail, release state; pos and floor_n as scalars) and the
// envelope history, so a stream may switch between this kernel and the
// plain step at any block.  The position logic comes from the scalars:
// the new frames valid (not over the latency padding, not straddling a
// drained stream's end) form an interval, and so do the first nf valid
// frames of the stream, which feed the floor.
//
// Schedule, one CTA of T threads per channel (256, or 512 at nfft 8192:
// one transform a batch and one exchange buffer, kOne), B = T R / N
// transforms a batch (4 at nfft 1024), the passes, merged passes, teams
// and named barriers of chain_regs_device.cuh:
//
//   1. FIR and analysis, in segments of fs new frames (the whole block
//      where it fits).  A segment's span of the gate input [in_tail |
//      filtered block] sits in shared memory: the in_tail part copied, the
//      rest the fill's FIR input in whole overlap-save blocks (the FIR
//      history before them), filtered in place by FIR batches of 2B blocks
//      (the forward's last pass, the product with hf and the inverse's
//      first pass merged: fir_middle).  The segment's frames then go in
//      batches of 2B, frames 2t and 2t + 1 as re/im of transform t,
//      windowed as the first pass loads them; the forward's last pass
//      untangles each bin pair (k, N-k) in registers (for_bin_pairs) into
//      the two frames' half-spectrum bins, which go to their slot of the
//      new FIFO in device memory, or to the pop buffer when this same
//      block pops them (shared memory where it fits, else the scratch
//      rows); |X| of the frames that feed the floor goes to the masks
//      buffer, and one thread a bin adds them to the floor in frame order
//      (with one transform a batch the thread that holds the bin adds them
//      at once).
//   2. Synthesis, after the floor is final: the m popped frames in batches
//      of 2B.  With release > 0 one thread a bin first scans the batch's
//      masks, max-with-decay from the carried state (kOne: in the merged
//      pass's registers).  The inverse's first pass loads the popped
//      spectra straight into its registers, masks them and puts pairs back
//      together as Z = A + iB; the inverse passes follow and the last one
//      stores the windowed, 1/N-scaled frames in natural order (the
//      stage).  An overlap-add pass, each output position one thread's,
//      adds the carry and the stage's frames and emits each finished
//      position times the streaming 1/WOLA norm (or its magnitude into the
//      envelope's rectified row), the rest to the next carry, the last
//      batch's to ola_tail.
//   3. Envelope: a direct-form MAC of the reversed taps over the rectified
//      row [env history | |y|] (shared memory where it fits, else a
//      scratch row), times env_scale.
//
// With a cluster of two CTAs per channel (kCl = 2, nfft <= 4096) each CTA
// takes half of the block's batches, the first the larger half: its own
// segments of new frames (filtering the span they read) and its own popped
// frames.  The CTAs meet three times through distributed shared memory:
// after the analysis (the floor's two parts, first CTA's frames first,
// where the block feeds the floor; the popped spectra of the first CTA's
// frames, which the second synthesizes), before the second CTA's first
// overlap-add (the first CTA's carry, and the envelope's input before
// its outputs), and before either exits.  The second CTA's release scan
// first runs over the first CTA's frames (masks only).
//
// Shared memory (floats), at the offsets the wrapper computes
// (kernels/chain_kernel.py, step_regs_geometry): floor sum and release
// state (nb = N/2 + 1 each), the masks buffer (2B nb; none with kOne), two
// OLA carries (d = N - H each), the span, the pop buffer (2 (m - nf) nb,
// or none), the rectified row (Te - 1 + b, or none), the exchange buffers
// (two of 2 T R, or one with kOne), which the fill may also use as scratch
// before the FIR's first pass; with a cluster, the second CTA's floor part
// (nb) last.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chain_regs_device.cuh"

namespace asp {

// Field for field the ctypes structure GateStepArgs of
// kernels/gate_kernel.py.  Carry arrays are per channel contiguous:
// in_tail (d), fifo (nf, nb), floor_sum (nb), ola_tail (d), rel (nb);
// scratch (max(m - nf, 0), nb); d = N - hop, nb = N/2 + 1.
struct GateStepArgs {
  const float* x;
  float* out;
  const float* in_tail;
  const float* fifo_r;
  const float* fifo_i;
  const float* floor_sum;
  const float* ola_tail;
  const float* rel;
  float* in_tail_out;
  float* fifo_r_out;
  float* fifo_i_out;
  float* floor_sum_out;
  float* ola_tail_out;
  float* rel_out;
  float* scratch_r;
  float* scratch_i;
  const float* win;       // N, periodic window
  const float2* tw;       // unused (it keeps the offsets of the fields after it)
  const float* inv_head;  // d, 1 / head ramp of the WOLA norm
  const float* inv_tail;  // d, 1 / finite-file ramp-out
  int channels;
  int x_ld;           // row stride of x
  int b;              // block, a multiple of hop
  int nfft;           // N, a power of two
  int log2n;
  int hop;
  int nf;             // noise frames, the FIFO depth
  int pos;            // stream position of the block's first sample
  int floor_n;        // valid frames seen so far (floor takes)
  int input_latency;  // zeros before the real stream
  int latency;        // this stage's latency
  int eof_in;         // drained stream: one past the last real input; -1 off
  int eof_out;        // drained stream: whole-file synthesis length; -1 off
  int ring;           // unused (as tw)
  int has_release;
  float thresh_gain;
  float att;
  float release;
  float inv_const;    // 1 / interior WOLA norm
};

// 1 / the streaming WOLA norm at output position p (wola_norm_at of
// kernels/gate_kernel.py); Args: any argument struct with inv_head,
// inv_const, eof_out and inv_tail (the gate and stretch steps share it)
template <class Args>
__device__ __forceinline__ float gate_inv_norm(const Args& a, int p, int d) {
  float v = p < 0 ? 1.0f : (p < d ? a.inv_head[p] : a.inv_const);
  if (a.eof_out >= 0) {
    if (p >= a.eof_out) v = 1.0f;
    else if (p >= a.eof_out - d) v = a.inv_tail[p - (a.eof_out - d)];
  }
  return v;
}

// Field for field the ctypes structure FirEnvArgs of
// kernels/chain_kernel.py.  Per channel contiguous: hist (T-1), env_hist
// (Te-1), rect (Te-1+b, when in device memory).
struct FirEnvArgs {
  const float* hist;          // FIR history
  float* hist_out;
  const float2* hf;           // N-point spectrum of the zero-padded FIR taps
  const float2* twf;          // stockham_table(N, -1)
  const float2* twi;          // stockham_table(N, +1)
  const float* env_hist;      // envelope history (rectified)
  float* env_hist_out;
  const float* env_taps_rev;  // Te envelope taps, reversed
  float* rect;                // the rectified rows in device memory, or null: shared
  int taps;                   // T, T - 1 < N
  int env_taps;               // Te; 0: no envelope
  float env_scale;
  int fs;                     // new frames a segment, a multiple of 2B
  int pop_smem;               // 1: the pop buffer in shared memory, else scratch_r/i
  int o_masks;                // shared memory offsets, floats
  int o_carry;
  int o_span;
  int o_pop;
  int o_rect;
  int o_ex;
  int o_part;                 // the second CTA's floor part (a cluster of two)
};

// The CTAs of a channel's cluster: this one's rank, their barrier (with
// release and acquire: shared and device memory written before it are
// seen after it), and a peer's shared memory at the address of p.
__device__ __forceinline__ int cl_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

__device__ __forceinline__ void cl_sync() { cooperative_groups::this_cluster().sync(); }

template <class T>
__device__ __forceinline__ T* cl_peer(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// CTAs per channel of the step body on `threads` threads: a cluster of two
// up to nfft 4096; one CTA of 512 threads at 8192, whose one exchange
// buffer leaves no room for the peer's floor part.
__host__ __device__ __forceinline__ constexpr int step_ctas(int threads) {
  return threads > kRegsThreads ? 1 : 2;
}

// Launch a step kernel for nfft on `stream`: step_ctas CTAs a channel of
// regs_threads(nfft) threads, a cluster (cudaLaunchKernelEx's cluster
// attribute) where two, `smem_bytes` of dynamic shared memory.  Returns
// cudaGetLastError() after the launch: 0 on success.
template <class... Params, class... Args>
int launch_step(void (*kernel)(Params...), int nfft, int channels, int smem_bytes,
                void* stream, const Args&... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = regs_threads(nfft), ctas = step_ctas(threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(channels * ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// floor(a / b) and ceil(a / b) for b > 0
__device__ __forceinline__ int step_floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int step_ceil_div(int a, int b) { return -step_floor_div(-a, b); }

// The forward passes of a batch, ending in a merged last pass that writes
// no exchange (mid(s0, load, swz_in): the analysis).  As regs_round_trip's
// forward half.  Returns after a __syncthreads().
template <int R, int RS, bool kOne, class First, class Mid>
__device__ __forceinline__ void regs_forward(int log2n, const Team& tm, float* ex, int cap,
                                             First first, Mid mid, const float2* twf) {
  if constexpr (R == RS) {  // one pass: nfft <= 16
    mid(0, first, false);
    __syncthreads();
  } else {
    constexpr int rs = pass_bits(RS);
    constexpr int kBuf = kOne ? 0 : 1;
    const auto in = [ex, cap](int p) {
      return PlanarIn{ex + (p & kBuf) * 2 * cap, ex + (p & kBuf) * 2 * cap + cap};
    };
    const auto out = [ex, cap](int p) {
      return PlanarOut{ex + (p & kBuf) * 2 * cap, ex + (p & kBuf) * 2 * cap + cap};
    };
    int s0, p = 0;
    if ((log2n - rs) % 4 == 3) {
      regs_pass<8>(log2n, 0, tm, first, false, out(p), true, twf);
      s0 = 3;
    } else {
      regs_pass<16>(log2n, 0, tm, first, false, out(p), true, twf);
      s0 = 4;
    }
    tm.sync();
    for (; s0 < log2n - rs; s0 += 4) {
      ++p;
      regs_pass<16, kOne, R>(log2n, s0, tm, in(p - 1), true, out(p), true, twf);
      tm.sync();
    }
    mid(s0, in(p), true);
    __syncthreads();
  }
}

// The exchange buffer the inverse's last pass reads (regs_inverse), so the
// stage goes to the other one (with two).
__device__ __forceinline__ int regs_inverse_last_read(int log2n, int rs) {
  int s0 = rs, p = 0;
  if ((log2n - rs) % 4 == 3) {
    ++p;
    s0 += 3;
  }
  for (; s0 + 4 < log2n; s0 += 4) ++p;
  return p;
}

// The inverse passes of a batch from a merged first pass that reads no
// exchange (mid(store, swz_out): the synthesis), the last writing through
// `last`.  As regs_round_trip's inverse half.  Returns after a
// __syncthreads().
template <int R, int RS, bool kOne, class Mid, class Last>
__device__ __forceinline__ void regs_inverse(int log2n, const Team& tm, float* ex, int cap,
                                             Mid mid, Last last, const float2* twi) {
  if constexpr (R == RS) {
    mid(last, false);
    __syncthreads();
  } else {
    constexpr int rs = pass_bits(RS);
    constexpr int kBuf = kOne ? 0 : 1;
    const auto in = [ex, cap](int p) {
      return PlanarIn{ex + (p & kBuf) * 2 * cap, ex + (p & kBuf) * 2 * cap + cap};
    };
    const auto out = [ex, cap](int p) {
      return PlanarOut{ex + (p & kBuf) * 2 * cap, ex + (p & kBuf) * 2 * cap + cap};
    };
    mid(out(0), true);
    tm.sync();
    int s0 = rs, p = 0;
    if ((log2n - rs) % 4 == 3) {
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

// The units of a merged pass (two mirror groups each, as gate_middle): unit
// i of this lane, its transform t and its first group u.
struct StepUnits {
  int lg, lu, w0, size;
  __device__ __forceinline__ int t(int i) const { return (w0 + i * size) >> lu; }
  __device__ __forceinline__ int u(int i) const { return (w0 + i * size) & ((1 << lu) - 1); }
  __device__ __forceinline__ int mirror(int u) const {
    return u == 0 ? (lg > 0 ? 1 << (lg - 1) : 0) : (1 << lg) - u;
  }
};

__device__ __forceinline__ StepUnits step_units(int log2n, int rs, const Team& tm) {
  const int lg = log2n - rs, lu = lg > 0 ? lg - 1 : 0;
  return StepUnits{lg, lu, (tm.first << lu) + tm.lane, tm.size};
}

// One block of the step on channel c, every thread calling it; kCl =
// step_ctas(T) CTAs per channel (a cluster where 2).  fill(span, s, len,
// scratch): stores the FIR input u[s + i] (the FIR history where s + i <
// 0, zero past the block) in span[i] for i < len (kFir false: the gate
// input's block x[s + i]), may use `scratch` (the exchange buffers) and
// returns after a __syncthreads().
template <int R, int RS, bool kFir, int T, class Fill>
__device__ void fir_gate_step_regs(const GateStepArgs& a, const FirEnvArgs& f, int c,
                                   float* smem, const Fill& fill) {
  constexpr bool kOne = T > kRegsThreads;
  constexpr int kCl = step_ctas(T);
  const bool release = a.has_release != 0;  // a uniform branch: one instantiation serves both
  constexpr int rs = pass_bits(RS);
  constexpr int kUnits = R == RS ? 1 : 8 / RS;  // units of a merged pass a lane
  const int N = a.nfft, L = a.log2n, H = a.hop, d = N - H, nb = N / 2 + 1, r = N / H;
  const int b = a.b, m = b / H, nf = a.nf, ns = m > nf ? m - nf : 0;
  const int cap = T * R, B = cap >> L, nfb = 2 * B;
  const int tid = threadIdx.x;
  const int lh = __ffs(H) - 1;
  const Team tm = regs_team<T>(L, B, R);
  const StepUnits su = step_units(L, rs, tm);
  const float inv_n = 1.0f / static_cast<float>(N);
  const float* __restrict__ win = a.win;
  float* fsum = smem;
  float* rel = smem + nb;
  float* masks = smem + f.o_masks;
  float* carry = smem + f.o_carry;
  float* span = smem + f.o_span;
  float* ex = smem + f.o_ex;
  const size_t cnb = static_cast<size_t>(c) * nb, cd = static_cast<size_t>(c) * d;
  const size_t fifo_off = static_cast<size_t>(c) * nf * nb;
  const float* fr_in = a.fifo_r + fifo_off;
  const float* fi_in = a.fifo_i + fifo_off;
  float* fr_out = a.fifo_r_out + fifo_off;
  float* fi_out = a.fifo_i_out + fifo_off;
  const size_t pop_off = static_cast<size_t>(c) * ns * nb;  // the scratch rows' channel
  float* pop_r = f.pop_smem ? smem + f.o_pop : a.scratch_r + pop_off;
  float* pop_i = f.pop_smem ? smem + f.o_pop + ns * nb : a.scratch_i + pop_off;
  const int te = f.env_taps, ehl = te > 0 ? te - 1 : 0;
  float* rect = f.rect ? f.rect + static_cast<size_t>(c) * (ehl + b) : smem + f.o_rect;
  float* out = a.out + static_cast<size_t>(c) * b;
  // this CTA's new and popped frames [f_lo, f_hi): whole batches, the first
  // CTA of a cluster the larger half; the CTA with the block's last frame
  const int rank = kCl > 1 ? cl_rank() : 0;
  const int split = kCl > 1 ? min(m, (m + 2 * nfb - 1) / (2 * nfb) * nfb) : m;
  const int f_lo = rank == 0 ? 0 : split, f_hi = rank == 0 ? split : m;
  const int last_rank = split < m ? 1 : 0;
  float* fpart = smem + f.o_part;  // the second CTA's floor part

  // new frame j starts at ext position j H, stream position pos - d + j H:
  // valid for j in [jv0, jv1), feeding the floor for j in [jv0, jt1)
  const int start0 = a.pos - d;
  const int jv0 = max(0, step_ceil_div(a.input_latency - start0, H));
  int jv1 = m;
  if (a.eof_in >= 0) jv1 = min(m, step_floor_div(a.eof_in - N - start0, H) + 1);
  jv1 = max(jv1, jv0);
  const int jt1 = min(jv1, jv0 + max(0, nf - a.floor_n));

  // ---- the carries in
  for (int k = tid; k < nb; k += T) {
    fsum[k] = a.floor_sum[cnb + k];
    rel[k] = release ? a.rel[cnb + k] : 0.0f;
    if (kCl > 1 && rank == 1) fpart[k] = 0.0f;
  }
  if (rank == 0) {
    for (int i = tid; i < d; i += T) carry[i] = a.ola_tail[cd + i];
    for (int i = tid; i < (nf - m) * nb; i += T) {  // FIFO frames the block does not pop
      fr_out[i] = fr_in[m * nb + i];
      fi_out[i] = fi_in[m * nb + i];
    }
  }
  for (int i = tid; i < ehl; i += T) rect[i] = f.env_hist[static_cast<size_t>(c) * ehl + i];
  __syncthreads();

  // ---- 1. FIR and analysis, a segment of new frames [j0, j1) at a time
  float* fdst = kCl > 1 && rank == 1 ? fpart : fsum;  // where this CTA's takes add up
  for (int j0 = f_lo; j0 < f_hi; j0 += f.fs) {
    const int j1 = min(f_hi, j0 + f.fs);
    const int e0 = j0 * H;                      // span[0] is ext position e0
    const int tl = max(0, d - e0);              // of which in_tail supplies the first tl
    const int seg = (j1 - j0 - 1) * H + N;
    for (int i = tid; i < tl; i += T) span[i] = a.in_tail[cd + e0 + i];
    float* fsp = span + tl;
    if constexpr (kFir) {
      // fsp[i] ends up holding the filtered y[y0 + i]
      const int hl = f.taps - 1, blk = N - hl;
      const int y0 = max(0, e0 - d);
      const int nblk = (seg - tl + blk - 1) / blk;
      fill(fsp, y0 - hl, nblk * blk + hl, ex);
      if (j1 == m) {  // the last hl samples of [history | input], before they are filtered
        for (int i = tid; i < hl; i += T) {
          f.hist_out[static_cast<size_t>(c) * hl + i] = fsp[b - y0 + i];
        }
      }
      for (int k0 = 0; k0 < nblk; k0 += 2 * B) {
        // transform t (index i >> L) takes blocks k0 + 2t (re) and k0 + 2t + 1 (im)
        const auto load = [fsp, k0, nblk, blk, L, N](int i) {
          const int kb = k0 + 2 * (i >> L), o = kb * blk + (i & (N - 1));
          return make_float2(kb < nblk ? fsp[o] : 0.0f, kb + 1 < nblk ? fsp[o + blk] : 0.0f);
        };
        const auto store = [fsp, k0, nblk, blk, hl, L, N, inv_n](int i, float2 v) {
          const int kb = k0 + 2 * (i >> L), o = (i & (N - 1)) - hl;
          if (o < 0) return;
          if (kb < nblk) fsp[kb * blk + o] = v.x * inv_n;
          if (kb + 1 < nblk) fsp[(kb + 1) * blk + o] = v.y * inv_n;
        };
        const auto mid = [&](int s0, auto ld, bool si, auto st, bool so) {
          fir_middle<RS, R == RS, kOne, R>(L, s0, tm, ld, si, st, so, f.twf, f.twi, f.hf);
        };
        regs_round_trip<R, RS, true, kOne>(L, tm, ex, cap, load, mid, store, f.twf, f.twi);
      }
    } else {
      fill(fsp, e0 + tl - d, seg - tl, ex);
    }
    if (j1 == m) {  // the new in_tail: ext[b, b + d)
      for (int i = tid; i < d; i += T) a.in_tail_out[cd + i] = span[b - e0 + i];
    }
    for (int q0 = j0; q0 < j1; q0 += nfb) {
      const int nfr = min(nfb, j1 - q0);
      const bool takes = q0 < jt1 && q0 + nfr > jv0;
      const float* f0 = span + (q0 - j0) * H;
      const auto load = [f0, win, nfr, q0, jv0, jv1, H, L, N](int i) {
        const int fa = 2 * (i >> L), k = i & (N - 1);
        const float w = __ldg(win + k);
        const float* p = f0 + fa * H + k;
        const int fq = q0 + fa;
        return make_float2(fa < nfr && fq >= jv0 && fq < jv1 ? p[0] * w : 0.0f,
                           fa + 1 < nfr && fq + 1 >= jv0 && fq + 1 < jv1 ? p[H] * w : 0.0f);
      };
      // frame fa of the batch, bin kk: the floor, the FIFO or the pop buffer
      const auto spec = [&](int fa, int kk, float xr, float xi) {
        if (fa >= nfr) return;
        const int fq = q0 + fa;
        if (fq >= jv0 && fq < jt1) {
          const float mag = sqrtf(xr * xr + xi * xi);
          if constexpr (kOne) {
            fsum[kk] += mag;
          } else {
            masks[fa * nb + kk] = mag;
          }
        }
        const int v = nf + fq;  // its place in [FIFO | new]
        if (v >= m) {
          fr_out[static_cast<size_t>(v - m) * nb + kk] = xr;
          fi_out[static_cast<size_t>(v - m) * nb + kk] = xi;
        } else {
          pop_r[static_cast<size_t>(fq) * nb + kk] = xr;
          pop_i[static_cast<size_t>(fq) * nb + kk] = xi;
        }
      };
      const auto mid = [&](int s0, auto ld, bool si) {
        int rsw[rs];
        stockham_read_offsets<RS>(rsw, L, s0, si);
#pragma unroll 1
        for (int i = 0; i < kUnits; ++i) {
          const int t = su.t(i), u = su.u(i);
          float2 z[RS], y[RS];
          stockham_group<RS>(z, (t << su.lg) | u, L, s0, ld, si, rsw, f.twf);
          if (su.lg > 0) {
            stockham_group<RS>(y, (t << su.lg) | su.mirror(u), L, s0, ld, si, rsw, f.twf);
          }
          for_bin_pairs<RS>(z, y, u, su.lg, [&](float2& zk, float2& zn, int k) {
            // p = Z[kk], q = Z[N - kk] of the half-spectrum's bin kk
            const bool hi = 2 * k > N;
            const float2 p = hi ? zn : zk, q = hi ? zk : zn;
            const int kk = hi ? N - k : k;
            spec(2 * t, kk, 0.5f * (p.x + q.x), 0.5f * (p.y - q.y));
            spec(2 * t + 1, kk, 0.5f * (p.y + q.y), -0.5f * (p.x - q.x));
          });
        }
      };
      regs_forward<R, RS, kOne>(L, tm, ex, cap, load, mid, f.twf);
      if constexpr (!kOne) {
        if (takes) {  // the floor, frame by frame in order
          for (int k = tid; k < nb; k += T) {
            float s = fdst[k];
            for (int fa = 0; fa < nfr; ++fa) {
              if (q0 + fa >= jv0 && q0 + fa < jt1) s += masks[fa * nb + k];
            }
            fdst[k] = s;
          }
          __syncthreads();
        }
      }
    }
  }
  if constexpr (kCl > 1) {
    cl_sync();  // every spectrum of the block and both floor parts written
    if (jt1 > jv0) {  // the block fed the floor: the first CTA's sum, then the second's part
      const float* other = cl_peer(rank == 0 ? fpart : fsum, rank ^ 1);
      for (int k = tid; k < nb; k += T) masks[k] = rank == 0 ? fsum[k] + other[k]
                                                               : other[k] + fpart[k];
      cl_sync();
      for (int k = tid; k < nb; k += T) fsum[k] = masks[k];
      __syncthreads();
    }
  }

  // ---- 2. synthesis of the popped frames [FIFO | new][0, m), against the
  // block's final floor
  const float nf_f = static_cast<float>(nf);
  const int p0 = a.pos - a.latency - a.input_latency;
  // the pop buffer of the CTA that analysed new frame j (a cluster's peer
  // holds those before `split`)
  const float* pr_peer = pop_r;
  const float* pi_peer = pop_i;
  if (kCl > 1 && f.pop_smem) {
    pr_peer = cl_peer(pop_r, rank ^ 1);
    pi_peer = cl_peer(pop_i, rank ^ 1);
  }
  const auto popped = [&](int q, int k) {
    if (q < nf) {
      return make_float2(fr_in[static_cast<size_t>(q) * nb + k],
                         fi_in[static_cast<size_t>(q) * nb + k]);
    }
    const size_t o = static_cast<size_t>(q - nf) * nb + k;
    const bool mine = kCl == 1 || ((q - nf < split) == (rank == 0));
    return mine ? make_float2(pop_r[o], pop_i[o]) : make_float2(pr_peer[o], pi_peer[o]);
  };
  const auto raw_mask = [&](float2 v, int k) {
    return sqrtf(v.x * v.x + v.y * v.y) > fsum[k] / nf_f * a.thresh_gain ? 1.0f : a.att;
  };
  const int sidx = kOne || R == RS ? 0 : (regs_inverse_last_read(L, rs) + 1) & 1;
  float* stage_re = ex + sidx * 2 * cap;
  float* stage_im = stage_re + cap;
  if constexpr (kCl > 1) {  // the second CTA: the release scan over the first's frames
    if (release && rank == 1) {
      for (int k = tid; k < nb; k += T) {
        float s = rel[k];
        for (int q = 0; q < f_lo; ++q) s = fmaxf(raw_mask(popped(q, k), k), a.release * s);
        rel[k] = s;
      }
      __syncthreads();
    }
  }
  int cur = 0;
  for (int q0 = f_lo; q0 < f_hi; q0 += nfb) {
    const int nfr = min(nfb, f_hi - q0);
    if (!kOne && release) {  // the masks, scanned along the batch's frames
      for (int k = tid; k < nb; k += T) {
        float s = rel[k];
        for (int fa = 0; fa < nfr; ++fa) {
          s = fmaxf(raw_mask(popped(q0 + fa, k), k), a.release * s);
          masks[fa * nb + k] = s;
        }
        rel[k] = s;
      }
      __syncthreads();
    }
    const auto mid = [&](auto st, bool so) {
      int wsw[rs];
      stockham_write_offsets<RS>(wsw, L, so);
#pragma unroll 1
      for (int i = 0; i < kUnits; ++i) {
        const int t = su.t(i), u = su.u(i), fa = 2 * t;
        float2 z[RS], y[RS];
        for_bin_pairs<RS>(z, y, u, su.lg, [&](float2& zk, float2& zn, int k) {
          const bool hi = 2 * k > N;
          const int kk = hi ? N - k : k;
          const float2 pa = fa < nfr ? popped(q0 + fa, kk) : make_float2(0.0f, 0.0f);
          const float2 pb = fa + 1 < nfr ? popped(q0 + fa + 1, kk) : make_float2(0.0f, 0.0f);
          float ma = 0.0f, mb = 0.0f;
          if (!kOne && release) {
            if (fa < nfr) ma = masks[fa * nb + kk];
            if (fa + 1 < nfr) mb = masks[(fa + 1) * nb + kk];
          } else {
            if (fa < nfr) ma = raw_mask(pa, kk);
            if (fa + 1 < nfr) mb = raw_mask(pb, kk);
            if (release) {  // kOne: the batch's two frames are this thread's
              ma = fmaxf(ma, a.release * rel[kk]);
              if (nfr > 1) mb = fmaxf(mb, a.release * ma);
              rel[kk] = nfr > 1 ? mb : ma;
            }
          }
          // the inverse real transform ignores the imaginary parts of the DC
          // and Nyquist bins; bin N - kk holds the conjugates
          const bool edge = 2 * kk == N || kk == 0;
          const float sg = hi ? -1.0f : 1.0f;
          const float ar = pa.x * ma, ai = edge ? 0.0f : sg * pa.y * ma;
          const float br = pb.x * mb, bi = edge ? 0.0f : sg * pb.y * mb;
          // Z = A + iB at k, and its Hermitian partner at N - k
          zk = make_float2(ar - bi, ai + br);
          zn = make_float2(ar + bi, br - ai);
        });
        inverse_first<RS>(z, L, t, u, st, so, wsw, f.twi);
        if (su.lg > 0) inverse_first<RS>(y, L, t, su.mirror(u), st, so, wsw, f.twi);
      }
    };
    const auto last = [stage_re, stage_im, win, inv_n, N](int i, float2 v) {
      const float w = __ldg(win + (i & (N - 1))) * inv_n;
      stage_re[i] = v.x * w;
      stage_im[i] = v.y * w;
    };
    regs_inverse<R, RS, kOne>(L, tm, ex, cap, mid, last, f.twi);
    // ---- overlap-add: position p of the batch (from q0's start) is thread
    // p mod T's; frame f of the batch is stage (f odd ? im : re) of
    // transform f/2
    const float* cin = carry + cur * d;
    if (kCl > 1 && rank == 1 && q0 == f_lo) {  // the first CTA's carry, once it is final
      cl_sync();
      cin = cl_peer(carry + ((split / nfb) & 1) * d, 0);
    }
    float* cout = carry + (cur ^ 1) * d;
    const int fin = nfr * H;
    const bool end = q0 + nfr == m;
    for (int p = tid; p < fin + d; p += T) {
      float v = p < d ? cin[p] : 0.0f;
      const int k = p >> lh;
      const int f_hi = min(nfr - 1, k);
      for (int fq = max(0, k - r + 1); fq <= f_hi; ++fq) {
        v += ((fq & 1) ? stage_im : stage_re)[(fq >> 1) * N + p - (fq << lh)];
      }
      if (p < fin) {
        const int gp = q0 * H + p;
        const float e = v * gate_inv_norm(a, p0 + gp, d);
        if (te > 0) {
          rect[ehl + gp] = fabsf(e);
        } else {
          out[gp] = e;
        }
      } else if (end) {
        a.ola_tail_out[cd + p - fin] = v;
      } else {
        cout[p - fin] = v;
      }
    }
    cur ^= 1;
    __syncthreads();
  }
  if constexpr (kCl > 1) {
    if (rank == 0 || f_lo == f_hi) cl_sync();  // the first CTA's overlap-adds are done
    if (te > 0 && rank == 1 && f.rect == nullptr) {  // the envelope's input before its outputs
      const float* peer = cl_peer(rect, 0);
      for (int i = tid; i < ehl; i += T) rect[f_lo * H + i] = peer[f_lo * H + i];
      __syncthreads();
    }
  }

  // ---- 3. envelope: |y| with its history through the reversed taps, four
  // outputs T apart a thread (four independent chains, one tap load each)
  if (te > 0) {
    const float* __restrict__ hr = f.env_taps_rev;
    const int o_hi = f_hi * H;
    for (int o0 = f_lo * H + tid; o0 < o_hi; o0 += 4 * T) {
      const float* w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = rect + min(o0 + i * T, o_hi - 1);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < te; ++j) {
        const float hj = __ldg(hr + j);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(hj, w[i][j], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (o0 + i * T < o_hi) out[o0 + i * T] = acc[i] * f.env_scale;
      }
    }
    if (rank == last_rank) {
      for (int i = tid; i < ehl; i += T) {
        f.env_hist_out[static_cast<size_t>(c) * ehl + i] = rect[b + i];
      }
    }
  }
  for (int k = tid; k < nb; k += T) {
    if (rank == 0) a.floor_sum_out[cnb + k] = fsum[k];
    if (release && rank == last_rank) a.rel_out[cnb + k] = rel[k];
  }
  if constexpr (kCl > 1) cl_sync();  // no CTA leaves while its peer may read its memory
}

}  // namespace asp
