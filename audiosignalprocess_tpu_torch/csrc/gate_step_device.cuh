// The streaming noise-gate step on one channel, for Hopper (sm_90a):
// the device body that gate_step_kernel.cu and fir_gate_step_kernel.cu
// share, so the two step kernels cannot drift apart.
//
// It computes what the JAX package's plain GateStage.step computes, with
// the same carry (planar spectral FIFO of nf frames, per-bin floor sum,
// OLA tail, release state) and the same position logic, evaluated here
// from scalars (no per-block masks built on the host):
//
//   pass A, analysis: the block's m new frames of [in_tail | input],
//     windowed, two frames per complex transform (re/im), untangled per
//     bin pair (k, N-k).  Frames over the latency padding, and in a
//     drained stream frames straddling end-of-file, are zero.  The first
//     nf valid frames of the stream add |X| to the floor sum.  Each new
//     spectrum goes to its FIFO slot, or to scratch when this same block
//     pops it (m > nf).
//   pass B, synthesis: the oldest m frames of [FIFO | new] are popped in
//     order, masked against the final floor of this block (hard
//     threshold, then the max-with-decay release carried across blocks),
//     put back together two per inverse transform, windowed and
//     overlap-added into a ring; each hop is emitted, times the 1/WOLA
//     norm of its stream position, as soon as no later frame touches it.
//
// Pass A finishes before pass B starts, so every floor-take frame of the
// block is in the floor before any popped frame is masked.
#pragma once

#include <cuda_runtime.h>

#include "fft_device.cuh"

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
  const float2* tw;       // N/2 twiddles
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
  int ring;           // OLA ring length, a power of two >= N + hop
  int has_release;
  float thresh_gain;
  float att;
  float release;
  float inv_const;    // 1 / interior WOLA norm
};

// Shared memory the body uses, in this order (floats): twiddles (N),
// FFT buffer (2N), floor sum (nb), release state (nb), OLA ring (ring).
// The caller loads the twiddles into `tw_s` before the call.
struct GateSmem {
  float2* tw_s;
  float2* z;
  float* fsum;
  float* rel;
  float* acc;
  __device__ GateSmem(float* base, int n_fft)
      : tw_s(reinterpret_cast<float2*>(base)),
        z(reinterpret_cast<float2*>(base) + n_fft / 2),
        fsum(reinterpret_cast<float*>(z + n_fft)),
        rel(fsum + n_fft / 2 + 1),
        acc(rel + n_fft / 2 + 1) {}
};

// sample i of one row of a tensor
struct RowSrc {
  const float* row;
  __device__ __forceinline__ float operator()(int i) const { return row[i]; }
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

__device__ __forceinline__ bool gate_frame_valid(const GateStepArgs& a, int start) {
  return start >= a.input_latency && (a.eof_in < 0 || start + a.nfft <= a.eof_in);
}

// One block of the gate on channel c.  src(i): sample i < b of this
// block's gate input.  y: the channel's b emitted samples.
template <class Src>
__device__ void gate_step_channel(const GateStepArgs& a, int c, const Src& src,
                                  float* __restrict__ y, const GateSmem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.nfft, H = a.hop, d = N - H, nb = N / 2 + 1;
  const int m = a.b / H, nf = a.nf, rmask = a.ring - 1;
  const int ns = m > nf ? m - nf : 0;  // frames popped in the block they arrive
  const float inv_n = 1.0f / static_cast<float>(N);
  const size_t fifo_off = static_cast<size_t>(c) * nf * nb;
  const float* in_tail = a.in_tail + static_cast<size_t>(c) * d;
  const float* fr = a.fifo_r + fifo_off;
  const float* fi = a.fifo_i + fifo_off;
  float* fr_out = a.fifo_r_out + fifo_off;
  float* fi_out = a.fifo_i_out + fifo_off;
  float* sr = a.scratch_r + static_cast<size_t>(c) * ns * nb;
  float* si = a.scratch_i + static_cast<size_t>(c) * ns * nb;
  // gate input of the block, extended by the carried tail: ext(i) for
  // i < d + b, frame j = ext[j*H, j*H + N)
  auto ext = [&](int i) { return i < d ? in_tail[i] : src(i - d); };

  for (int k = tid; k < nb; k += nt) {
    s.fsum[k] = a.floor_sum[static_cast<size_t>(c) * nb + k];
    s.rel[k] = a.has_release ? a.rel[static_cast<size_t>(c) * nb + k] : 0.0f;
  }
  for (int i = tid; i < a.ring; i += nt)
    s.acc[i] = i < d ? a.ola_tail[static_cast<size_t>(c) * d + i] : 0.0f;
  // FIFO frames that survive the block move to the front of the new FIFO
  for (int i = tid; i < (nf - m) * nb; i += nt) {
    fr_out[i] = fr[m * nb + i];
    fi_out[i] = fi[m * nb + i];
  }
  __syncthreads();

  // ---- pass A: analysis of the new frames j, j+1
  int seen = a.floor_n;
  for (int j = 0; j < m; j += 2) {
    const bool two = j + 1 < m;
    const int start = a.pos - d + j * H;
    const bool v0 = gate_frame_valid(a, start);
    const bool v1 = two && gate_frame_valid(a, start + H);
    seen += v0;
    const bool take0 = v0 && seen <= nf;
    seen += v1;
    const bool take1 = v1 && seen <= nf;
    for (int i = tid; i < N; i += nt) {
      const float w = a.win[i];
      s.z[i] = make_float2(v0 ? ext(j * H + i) * w : 0.0f,
                           v1 ? ext((j + 1) * H + i) * w : 0.0f);
    }
    __syncthreads();
    fft_shared(s.z, N, a.log2n, false, s.tw_s);
    for (int k = tid; k < nb; k += nt) {
      const int k2 = (N - k) & (N - 1);
      const float2 zk = s.z[k], zn = s.z[k2];
      // A = (Z[k] + conj Z[N-k]) / 2, B = (Z[k] - conj Z[N-k]) / 2i
      const float ar = 0.5f * (zk.x + zn.x), ai = 0.5f * (zk.y - zn.y);
      const float br = 0.5f * (zk.y + zn.y), bi = -0.5f * (zk.x - zn.x);
      if (take0) s.fsum[k] += sqrtf(ar * ar + ai * ai);
      if (take1) s.fsum[k] += sqrtf(br * br + bi * bi);
      // new frame j sits at FIFO position nf + j of [FIFO | new]
      for (int e = 0; e < (two ? 2 : 1); ++e) {
        const int v = nf + j + e;
        const float re = e ? br : ar, im = e ? bi : ai;
        if (v >= m) {
          fr_out[static_cast<size_t>(v - m) * nb + k] = re;
          fi_out[static_cast<size_t>(v - m) * nb + k] = im;
        } else {
          sr[static_cast<size_t>(j + e) * nb + k] = re;
          si[static_cast<size_t>(j + e) * nb + k] = im;
        }
      }
    }
    __syncthreads();
  }

  // ---- pass B: synthesis of the popped frames q, q+1
  const int p0 = a.pos - a.latency - a.input_latency;
  auto popped = [&](int q, int k) {
    return q < nf ? make_float2(fr[static_cast<size_t>(q) * nb + k], fi[static_cast<size_t>(q) * nb + k])
                  : make_float2(sr[static_cast<size_t>(q - nf) * nb + k],
                                si[static_cast<size_t>(q - nf) * nb + k]);
  };
  for (int q = 0; q < m; q += 2) {
    const bool two = q + 1 < m;
    for (int k = tid; k < nb; k += nt) {
      const float th = s.fsum[k] / static_cast<float>(nf) * a.thresh_gain;
      const float2 pa = popped(q, k);
      const float2 pb = two ? popped(q + 1, k) : make_float2(0.0f, 0.0f);
      float ma = sqrtf(pa.x * pa.x + pa.y * pa.y) > th ? 1.0f : a.att;
      float mb = 0.0f;
      if (two) mb = sqrtf(pb.x * pb.x + pb.y * pb.y) > th ? 1.0f : a.att;
      if (a.has_release) {
        ma = fmaxf(ma, a.release * s.rel[k]);
        if (two) mb = fmaxf(mb, a.release * ma);
        s.rel[k] = two ? mb : ma;
      }
      const int k2 = (N - k) & (N - 1);
      // the inverse real transform ignores the imaginary parts of the DC
      // and Nyquist bins
      const bool edge = k2 == k;
      const float ar = pa.x * ma, ai = edge ? 0.0f : pa.y * ma;
      const float br = pb.x * mb, bi = edge ? 0.0f : pb.y * mb;
      // Z = A + iB at k, and its Hermitian partner at N-k
      s.z[k] = make_float2(ar - bi, ai + br);
      if (!edge) s.z[k2] = make_float2(ar + bi, br - ai);
    }
    __syncthreads();
    fft_shared(s.z, N, a.log2n, true, s.tw_s);
    // overlap-add frame q (re) at [q*H, q*H + N) and frame q+1 (im) one
    // hop later; each thread owns positions, so no two threads add to one
    const int base = q * H;
    for (int u = tid; u < (two ? N + H : N); u += nt) {
      float v = u < N ? s.z[u].x * a.win[u] : 0.0f;
      if (two && u >= H) v += s.z[u - H].y * a.win[u - H];
      s.acc[(base + u) & rmask] += v * inv_n;
    }
    __syncthreads();
    // positions before the next frame's start are complete: emit, free
    for (int u = tid; u < (two ? 2 * H : H); u += nt) {
      const int p = base + u;
      y[p] = s.acc[p & rmask] * gate_inv_norm(a, p0 + p, d);
      s.acc[p & rmask] = 0.0f;
    }
    __syncthreads();
  }

  // ---- the new carry
  for (int i = tid; i < d; i += nt) {
    a.ola_tail_out[static_cast<size_t>(c) * d + i] = s.acc[(a.b + i) & rmask];
    a.in_tail_out[static_cast<size_t>(c) * d + i] = ext(a.b + i);
  }
  for (int k = tid; k < nb; k += nt) {
    a.floor_sum_out[static_cast<size_t>(c) * nb + k] = s.fsum[k];
    if (a.has_release) a.rel_out[static_cast<size_t>(c) * nb + k] = s.rel[k];
  }
}

}  // namespace asp
