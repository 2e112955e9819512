// The streaming phase-vocoder step on batched register Stockham
// transforms, for Hopper (sm_90a): the device body of
// stretch_step_kernel.cu, built from the pieces of the FIR -> gate step's
// body (fir_gate_step_regs.cuh: regs_forward, regs_inverse, the merged
// passes' units and bin pairs, launch_step, step_ctas, the overlap-add
// pass).
//
// Per channel and block it computes the JAX package's plain
// StretchStage.step with the plain path's carry (in_tail, the spectral
// FIFO of `depth` frames, z0 and acc per bin, the OLA tail; the block
// count as scalars), so a stream may switch between this kernel and the
// plain step at any block.  Schedule, per block of m analysis and mo
// synthesis frames, a CTA of T threads running B = T R / N transforms a
// batch (4 at nfft 1024; one at 8192, kOne):
//
//   1. Carries in: z0 and acc to shared memory; the old FIFO rows that
//      survive the block copied forward in device memory (depth - m rows).
//   2. Analysis: the m new frames in batches of 2B, frames 2t and 2t + 1
//      as re/im of transform t, read straight from [in_tail | x] in device
//      memory and windowed as the first pass loads them (there is no FIR
//      to filter in place, so no span in shared memory and no segments).
//      The forward's last pass untangles each bin pair (k, N-k) in
//      registers into the two frames' half-spectrum bins; each goes to
//      its row depth - m + j of the new FIFO in device memory (rows the
//      FIFO drops are not stored), and the first true analysis frame
//      (`hit`) adds its unit rotor to z0.
//   3. Synthesis, after the analysis: the mo frames in batches of 2B.  One
//      thread a bin runs the vocoder's recursion along the batch's frames
//      in order: slots s0 = slot[u] and s1 = s0 + 1 of the new FIFO (L2),
//      the advance rotor unit(s1 conj s0) (neutral where the frame is not
//      emitted), the phase z0 acc, the magnitude ((1 - f)|s0| + f|s1|)
//      emit, the synthesis bin mag phase into a shared buffer (2B frames),
//      then acc <- acc rot; with one transform a batch (kOne) the thread of
//      the merged pass that holds the bin runs it for the batch's two
//      frames, in registers.  The inverse's merged first pass puts each
//      pair back together as Z = A + iB (the imaginary parts of the DC and
//      Nyquist bins dropped), the inverse passes follow and the last one
//      stores the windowed, 1/N-scaled frames (the stage); an overlap-add
//      pass, each output position one thread's, emits each finished hop
//      times the streaming 1/WOLA norm, the rest to the next carry, the
//      last batch's to ola_tail.
//
// The recursion keeps the plain step's rounding: acc times the rotor in
// frame order, unit rotors with 1.0f / sqrtf (IEEE-rounded without fast
// math, not rsqrtf) and the guard |z|^2 > 1e-36 -> 1 + 0j, magnitudes by
// hypotf; the rotor recursion integrates every rounding over the stream.
//
// With a cluster of two CTAs per channel (nfft <= 4096) the CTAs split the
// analysis frames and then the synthesis frames in whole batches, the
// first the larger half.  A cluster barrier after the analysis makes the
// FIFO rows in device memory and z0 visible to both (z0 read from the
// peer's shared memory where the peer analysed the first true frame);
// the second CTA then runs the rotors of the first CTA's synthesis frames
// (rotors only, the same operations in the same order) to reach acc at
// its own first frame, and overlap-adds its frames from a zero carry, so
// neither CTA waits for the other's synthesis.  Once both are done the
// second adds the first CTA's final carry to its first d positions (the
// overlap-add is linear), and the CTAs meet once more before either exits.
//
// Shared memory (floats), at the offsets the wrapper computes
// (kernels/stretch_kernel.py, stretch_regs_geometry): z0 (re, im) and acc
// (re, im), nb = N/2 + 1 each; two OLA carries (d = N - H each); the
// synthesis bins of a batch (2 planes of 2B nb; none with kOne); the
// exchange buffers (two of 2 T R, or one with kOne).
#pragma once

#include <cuda_runtime.h>

#include "fir_gate_step_regs.cuh"

namespace asp {

// Field for field the ctypes structure StretchStepArgs of
// kernels/stretch_kernel.py.  Carry arrays are per channel contiguous:
// in_tail (d), fifo (depth, nb), z0/acc (nb), ola_tail (d).
struct StretchStepArgs {
  const float* x;
  float* out;
  const float* in_tail;
  const float* fifo_r;
  const float* fifo_i;
  const float* z0r;
  const float* z0i;
  const float* accr;
  const float* acci;
  const float* ola_tail;
  float* in_tail_out;
  float* fifo_r_out;
  float* fifo_i_out;
  float* z0r_out;
  float* z0i_out;
  float* accr_out;
  float* acci_out;
  float* ola_tail_out;
  const int* slots;      // mo, FIFO slot of s0 per synthesis frame
  const float* fracs;    // mo, interpolation weight of s1
  const float* win;      // N, periodic window
  const float2* twf;     // stockham_table(N, -1)
  const float2* twi;     // stockham_table(N, +1)
  const float* inv_head; // d, 1 / head ramp of the WOLA norm
  const float* inv_tail; // d, 1 / finite-file ramp-out
  int channels;
  int x_ld;     // row stride of x
  int nfft;     // N, a power of two >= 4
  int log2n;
  int hop;
  int m;        // analysis frames per block
  int mo;       // synthesis frames per block
  int depth;    // FIFO rows
  int hit;      // new frame that is the first true analysis frame; -1 none
  int i0;       // global index of the block's first synthesis frame
  int lo, hi;   // synthesis frames [lo, hi) are emitted
  int eof_out;  // drained stream: whole-file synthesis length; -1 off
  int o_carry;  // shared memory offsets, floats
  int o_syn;
  int o_ex;
  float inv_const;  // 1 / interior WOLA norm
};

__device__ __forceinline__ float2 unit_rotor(float zr, float zi) {
  const float m2 = zr * zr + zi * zi;
  if (m2 > 1e-36f) {
    const float inv = 1.0f / sqrtf(m2);
    return make_float2(zr * inv, zi * inv);
  }
  return make_float2(1.0f, 0.0f);
}

// FIFO slots s0 = slot[u] and s1 = s0 + 1 of synthesis frame u at bin k,
// from the new FIFO (written in this launch: plain loads, not __ldg)
struct SlotPair {
  float s0r, s0i, s1r, s1i;
};

__device__ __forceinline__ SlotPair slot_pair(const StretchStepArgs& a, const float* fr,
                                              const float* fi, int nb, int u, int k) {
  const size_t s = static_cast<size_t>(__ldg(a.slots + u));
  return SlotPair{fr[s * nb + k], fi[s * nb + k], fr[(s + 1) * nb + k], fi[(s + 1) * nb + k]};
}

// The advance rotor unit(s1 conj s0) of a frame, neutral where not emitted
__device__ __forceinline__ float2 advance_rotor(const SlotPair& p, bool emit) {
  return emit ? unit_rotor(p.s1r * p.s0r + p.s1i * p.s0i, p.s1i * p.s0r - p.s1r * p.s0i)
              : make_float2(1.0f, 0.0f);
}

// acc <- acc rot
__device__ __forceinline__ void advance(float& ar, float& ai, float2 rot) {
  const float nr = ar * rot.x - ai * rot.y;
  ai = ar * rot.y + ai * rot.x;
  ar = nr;
}

// Synthesis frame u's bin: mag z0 acc, then acc <- acc rot
__device__ __forceinline__ float2 vocoder_bin(const StretchStepArgs& a, const SlotPair& p, int u,
                                              float zr, float zi, float& ar, float& ai) {
  const bool emit = u >= a.lo && u < a.hi;
  const float f = __ldg(a.fracs + u);
  const float2 rot = advance_rotor(p, emit);
  const float phr = zr * ar - zi * ai, phi = zr * ai + zi * ar;
  const float mag = emit ? (1.0f - f) * hypotf(p.s0r, p.s0i) + f * hypotf(p.s1r, p.s1i) : 0.0f;
  advance(ar, ai, rot);
  return make_float2(mag * phr, mag * phi);
}

// The first CTA's share of n frames in batches of nfb: all of them, or with
// a cluster of two the larger half in whole batches (step_split of
// kernels/gate_kernel.py).
template <int kCl>
__device__ __forceinline__ int cta_split(int n, int nfb) {
  return kCl > 1 ? min(n, (n + 2 * nfb - 1) / (2 * nfb) * nfb) : n;
}

// One block of the stretch step on channel c, every thread calling it;
// kCl = step_ctas(T) CTAs per channel (a cluster where 2).
template <int R, int RS, int T>
__device__ void stretch_step_regs(const StretchStepArgs& a, int c, float* smem) {
  constexpr bool kOne = T > kRegsThreads;
  constexpr int kCl = step_ctas(T);
  constexpr int rs = pass_bits(RS);
  constexpr int kUnits = R == RS ? 1 : 8 / RS;  // units of a merged pass a lane
  const int N = a.nfft, L = a.log2n, H = a.hop, d = N - H, nb = N / 2 + 1, r = N / H;
  const int m = a.m, mo = a.mo, depth = a.depth;
  const int cap = T * R, B = cap >> L, nfb = 2 * B;
  const int tid = threadIdx.x;
  const int lh = __ffs(H) - 1;
  const Team tm = regs_team<T>(L, B, R);
  const StepUnits su = step_units(L, rs, tm);
  const float inv_n = 1.0f / static_cast<float>(N);
  const float* __restrict__ win = a.win;
  float* z0r = smem;
  float* z0i = smem + nb;
  float* accr = smem + 2 * nb;
  float* acci = smem + 3 * nb;
  float* carry = smem + a.o_carry;
  float* syn_r = smem + a.o_syn;
  float* syn_i = syn_r + nfb * nb;
  float* ex = smem + a.o_ex;
  const size_t cnb = static_cast<size_t>(c) * nb, cd = static_cast<size_t>(c) * d;
  const size_t fifo_off = static_cast<size_t>(c) * depth * nb;
  const float* xc = a.x + static_cast<size_t>(c) * a.x_ld;
  const float* tail = a.in_tail + cd;
  float* fr = a.fifo_r_out + fifo_off;
  float* fi = a.fifo_i_out + fifo_off;
  float* out = a.out + static_cast<size_t>(c) * mo * H;
  // block input extended by the carried tail: frame j = ext[j H, j H + N)
  const auto ext = [xc, tail, d](int i) { return i < d ? tail[i] : xc[i - d]; };
  // this CTA's analysis frames [a_lo, a_hi) and synthesis frames [s_lo,
  // s_hi); the CTA with the block's last synthesis frame
  const int rank = kCl > 1 ? cl_rank() : 0;
  const int a_split = cta_split<kCl>(m, nfb), s_split = cta_split<kCl>(mo, nfb);
  const int a_lo = rank == 0 ? 0 : a_split, a_hi = rank == 0 ? a_split : m;
  const int s_lo = rank == 0 ? 0 : s_split, s_hi = rank == 0 ? s_split : mo;
  const int last_rank = s_split < mo ? 1 : 0;

  // ---- 1. the carries in
  for (int k = tid; k < nb; k += T) {
    z0r[k] = a.z0r[cnb + k];
    z0i[k] = a.z0i[cnb + k];
    accr[k] = a.accr[cnb + k];
    acci[k] = a.acci[cnb + k];
  }
  if (rank == 0) {
    for (int i = tid; i < d; i += T) {
      carry[i] = a.ola_tail[cd + i];
      a.in_tail_out[cd + i] = ext(m * H + i);
    }
    const float* fr_in = a.fifo_r + fifo_off + static_cast<size_t>(m) * nb;
    const float* fi_in = a.fifo_i + fifo_off + static_cast<size_t>(m) * nb;
    for (int i = tid; i < (depth - m) * nb; i += T) {  // old rows the new FIFO keeps
      fr[i] = __ldg(fr_in + i);
      fi[i] = __ldg(fi_in + i);
    }
  }
  __syncthreads();

  // ---- 2. analysis of this CTA's new frames, a batch at a time
  for (int q0 = a_lo; q0 < a_hi; q0 += nfb) {
    const int nfr = min(nfb, a_hi - q0);
    const auto load = [&ext, win, nfr, q0, H, L, N](int i) {
      const int fa = 2 * (i >> L), k = i & (N - 1);
      const float w = __ldg(win + k);
      const int e = (q0 + fa) * H + k;
      return make_float2(fa < nfr ? ext(e) * w : 0.0f, fa + 1 < nfr ? ext(e + H) * w : 0.0f);
    };
    // frame fa of the batch, bin kk: its FIFO row, z0 from the first true frame
    const auto spec = [&](int fa, int kk, float xr, float xi) {
      if (fa >= nfr) return;
      const int j = q0 + fa, row = depth - m + j;
      if (row >= 0) {
        fr[static_cast<size_t>(row) * nb + kk] = xr;
        fi[static_cast<size_t>(row) * nb + kk] = xi;
      }
      if (j == a.hit) {
        const float2 u0 = unit_rotor(xr, xi);
        z0r[kk] += u0.x;
        z0i[kk] += u0.y;
      }
    };
    const auto mid = [&](int s0, auto ld, bool si) {
      int rsw[rs];
      stockham_read_offsets<RS>(rsw, L, s0, si);
#pragma unroll 1
      for (int i = 0; i < kUnits; ++i) {
        const int t = su.t(i), u = su.u(i);
        float2 z[RS], y[RS];
        stockham_group<RS>(z, (t << su.lg) | u, L, s0, ld, si, rsw, a.twf);
        if (su.lg > 0) {
          stockham_group<RS>(y, (t << su.lg) | su.mirror(u), L, s0, ld, si, rsw, a.twf);
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
    regs_forward<R, RS, kOne>(L, tm, ex, cap, load, mid, a.twf);
  }
  if constexpr (kCl > 1) {
    cl_sync();  // every FIFO row of the block and z0 written
    if (a.hit >= 0 && (a.hit < a_lo || a.hit >= a_hi)) {  // the peer analysed the first true frame
      const float* pr = cl_peer(z0r, rank ^ 1);
      const float* pi = cl_peer(z0i, rank ^ 1);
      for (int k = tid; k < nb; k += T) {
        z0r[k] = pr[k];
        z0i[k] = pi[k];
      }
    }
    if (rank == 1 && s_lo < s_hi) {  // acc at its first frame: the rotors of the first CTA's frames
      for (int k = tid; k < nb; k += T) {
        float ar = accr[k], ai = acci[k];
        SlotPair p = slot_pair(a, fr, fi, nb, 0, k);
        for (int u = 0; u < s_lo; ++u) {
          const SlotPair next = u + 1 < s_lo ? slot_pair(a, fr, fi, nb, u + 1, k) : p;
          advance(ar, ai, advance_rotor(p, u >= a.lo && u < a.hi));
          p = next;
        }
        accr[k] = ar;
        acci[k] = ai;
      }
    }
    __syncthreads();
  }

  // ---- 3. synthesis of this CTA's frames, a batch at a time
  const int p0 = a.i0 * H;
  const int sidx = kOne || R == RS ? 0 : (regs_inverse_last_read(L, rs) + 1) & 1;
  float* stage_re = ex + sidx * 2 * cap;
  float* stage_im = stage_re + cap;
  int cur = 0;
  for (int q0 = s_lo; q0 < s_hi; q0 += nfb) {
    const int nfr = min(nfb, s_hi - q0);
    if constexpr (!kOne) {  // the recursion, one thread a bin along the batch's frames
      for (int k = tid; k < nb; k += T) {
        float ar = accr[k], ai = acci[k];
        const float zr = z0r[k], zi = z0i[k];
        SlotPair p = slot_pair(a, fr, fi, nb, q0, k);
        for (int fa = 0; fa < nfr; ++fa) {
          const SlotPair next = fa + 1 < nfr ? slot_pair(a, fr, fi, nb, q0 + fa + 1, k) : p;
          const float2 s = vocoder_bin(a, p, q0 + fa, zr, zi, ar, ai);
          syn_r[fa * nb + k] = s.x;
          syn_i[fa * nb + k] = s.y;
          p = next;
        }
        accr[k] = ar;
        acci[k] = ai;
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
          float2 sa = make_float2(0.0f, 0.0f), sb = make_float2(0.0f, 0.0f);
          if constexpr (kOne) {  // the batch's two frames at bin kk are this thread's
            float ar = accr[kk], ai = acci[kk];
            const float zr = z0r[kk], zi = z0i[kk];
            sa = vocoder_bin(a, slot_pair(a, fr, fi, nb, q0, kk), q0, zr, zi, ar, ai);
            if (nfr > 1) {
              sb = vocoder_bin(a, slot_pair(a, fr, fi, nb, q0 + 1, kk), q0 + 1, zr, zi, ar, ai);
            }
            accr[kk] = ar;
            acci[kk] = ai;
          } else {
            if (fa < nfr) sa = make_float2(syn_r[fa * nb + kk], syn_i[fa * nb + kk]);
            if (fa + 1 < nfr) sb = make_float2(syn_r[(fa + 1) * nb + kk], syn_i[(fa + 1) * nb + kk]);
          }
          // the inverse real transform ignores the imaginary parts of the DC
          // and Nyquist bins; bin N - kk holds the conjugates
          const bool edge = 2 * kk == N || kk == 0;
          const float sg = hi ? -1.0f : 1.0f;
          const float ar = sa.x, ai = edge ? 0.0f : sg * sa.y;
          const float br = sb.x, bi = edge ? 0.0f : sg * sb.y;
          // Z = A + iB at k, and its Hermitian partner at N - k
          zk = make_float2(ar - bi, ai + br);
          zn = make_float2(ar + bi, br - ai);
        });
        inverse_first<RS>(z, L, t, u, st, so, wsw, a.twi);
        if (su.lg > 0) inverse_first<RS>(y, L, t, su.mirror(u), st, so, wsw, a.twi);
      }
    };
    const auto last = [stage_re, stage_im, win, inv_n, N](int i, float2 v) {
      const float w = __ldg(win + (i & (N - 1))) * inv_n;
      stage_re[i] = v.x * w;
      stage_im[i] = v.y * w;
    };
    regs_inverse<R, RS, kOne>(L, tm, ex, cap, mid, last, a.twi);
    // ---- overlap-add: position p of the batch (from q0's start) is thread
    // p mod T's; frame f of the batch is stage (f odd ? im : re) of
    // transform f/2.  The second CTA of a cluster starts from a zero carry
    // (the first CTA's is added once it is final, below)
    const float* cin = carry + cur * d;
    const bool zero_in = kCl > 1 && rank == 1 && q0 == s_lo;
    float* cout = carry + (cur ^ 1) * d;
    const int fin = nfr * H;
    const bool end = q0 + nfr == mo;
    for (int p = tid; p < fin + d; p += T) {
      float v = p < d && !zero_in ? cin[p] : 0.0f;
      const int k = p >> lh;
      const int f_hi = min(nfr - 1, k);
      for (int fq = max(0, k - r + 1); fq <= f_hi; ++fq) {
        v += ((fq & 1) ? stage_im : stage_re)[(fq >> 1) * N + p - (fq << lh)];
      }
      if (p < fin) {
        const int gp = q0 * H + p;
        out[gp] = v * gate_inv_norm(a, p0 + gp, d);
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
    cl_sync();  // both CTAs' overlap-adds are done: the first CTA's carry is final
    if (rank == 1 && s_lo < s_hi) {
      // the overlap-add is linear: the first CTA's carry adds to this CTA's
      // first d positions, emitted (times their norm) or in ola_tail
      const float* pc = cl_peer(carry + ((s_lo / nfb) & 1) * d, 0);
      const int tot = (s_hi - s_lo) * H;
      for (int j = tid; j < d; j += T) {
        if (j < tot) {
          const int gp = s_lo * H + j;
          out[gp] += pc[j] * gate_inv_norm(a, p0 + gp, d);
        } else {
          a.ola_tail_out[cd + j - tot] += pc[j];
        }
      }
    }
  }
  for (int k = tid; k < nb; k += T) {
    if (rank == 0) {
      a.z0r_out[cnb + k] = z0r[k];
      a.z0i_out[cnb + k] = z0i[k];
    }
    if (rank == last_rank) {
      a.accr_out[cnb + k] = accr[k];
      a.acci_out[cnb + k] = acci[k];
    }
  }
  if constexpr (kCl > 1) cl_sync();  // no CTA leaves while its peer may read its memory
}

}  // namespace asp
