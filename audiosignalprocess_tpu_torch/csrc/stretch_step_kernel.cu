// Streaming phase-vocoder step for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/stretch_kernel.py:stretch_step_fused.  One launch per
// Chain.step block of StretchStage: (carry, x) -> (carry', y), x of m*hop
// samples, y of mo*hop = m*q/p*hop samples, equal to the JAX package's
// plain StretchStage.step with the same carry (kernels/stretch_kernel.py
// documents it), so a stream may switch between this kernel and the
// plain step at any block.
//
//   pass A, analysis: the block's m new frames of [in_tail | x], windowed,
//     two frames per complex transform (re/im), untangled per bin pair
//     (k, N-k).  Each spectrum goes to its row of the NEW FIFO
//     [old FIFO | new frames][m : m + depth] in device memory (rows the
//     new FIFO drops are not stored); the old rows that survive are
//     copied forward.  The first true analysis frame (index `hit` of the
//     block, -1 when it is not in it) adds its unit rotor to z0.
//   pass B, synthesis, one pair of synthesis frames u, u+1 at a time:
//     each thread owns bins k and reads FIFO slots s0 = slot[u] and
//     s1 = slot[u] + 1; the advance rotor unit(s1 conj s0) (neutral when
//     the frame is not emitted), the phase z0 * acc, the magnitude
//     ((1-f)|s0| + f|s1|) * emit, the synthesis bin mag * phase, then
//     acc <- acc * rotor: the per-bin recursion runs sequentially along
//     the block's frames in the thread that owns the bin, so it needs no
//     scan and no mo-deep scratch.  The two frames go into one complex
//     inverse transform, are windowed and overlap-added into a ring;
//     each hop is emitted, times the 1/WOLA norm of its stream position
//     (head ramp, constant, finite-file ramp-out of a drained stream), as
//     soon as no later frame touches it.
//
// Positions arrive as scalars (hit, i0, the emitted frames [lo, hi),
// eof_out) and the slot/frac tables are uploaded once per geometry, so a
// step uploads nothing.  Precision: the recursion integrates every
// rounding of the rotors over the stream, so unit rotors use 1.0f /
// sqrtf (both IEEE-rounded without fast math), not rsqrtf, and keep the
// reference's guard |z|^2 > 1e-36 -> else 1+0j bit for bit.
//
// Design against the TPU kernel: the Pallas kernel ran the four-step
// grid FFT over the full spectrum with a batch tile of channels in VMEM
// and the FIFO in VMEM; none of that layout carries over.  The FIFO
// (depth x (N/2+1) complex per channel, 593 KB at 147/160) does not fit in
// shared memory at every rate, so it lives in device memory and is read
// back through L2.
//
// What bounds it on an H100: at 4/3, block 4096, N = 1024 (64 channels)
// a launch is 64 CTAs, each running 8 forward and 6 inverse complex
// 1024-point transforms one after the other plus the FIFO copy (17 x 513
// complex in and out); the radix-2 stages' barriers on under half the
// SMs bound it, as in the gate step.

#include <cuda_runtime.h>

#include "fft_device.cuh"
#include "gate_step_device.cuh"

namespace asp {

// Field for field the ctypes structure StretchStepArgs of
// kernels/stretch_kernel.py.  Carry arrays are per channel contiguous:
// in_tail (d), fifo (depth, nb), z0/acc (nb), ola_tail (d);
// d = N - hop, nb = N/2 + 1.
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
  const float2* tw;      // N/2 twiddles
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
  int ring;     // OLA ring length, a power of two >= N + hop
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

}  // namespace asp

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) stretch_step_kernel(asp::StretchStepArgs a) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nt = blockDim.x, c = blockIdx.x;
  const int N = a.nfft, H = a.hop, d = N - H, nb = N / 2 + 1;
  const int m = a.m, mo = a.mo, depth = a.depth, rmask = a.ring - 1;
  // shared memory: twiddles (N/2), FFT buffer (N), z0 and acc (nb each,
  // re and im), OLA ring
  float2* tw_s = reinterpret_cast<float2*>(smem4);
  float2* z = tw_s + N / 2;
  float* z0r = reinterpret_cast<float*>(z + N);
  float* z0i = z0r + nb;
  float* accr = z0i + nb;
  float* acci = accr + nb;
  float* ring = acci + nb;
  const float inv_n = 1.0f / static_cast<float>(N);
  const size_t cb = static_cast<size_t>(c) * nb, cd = static_cast<size_t>(c) * d;
  const size_t fifo_off = static_cast<size_t>(c) * depth * nb;
  const float* xr = a.x + static_cast<size_t>(c) * a.x_ld;
  const float* in_tail = a.in_tail + cd;
  const float* fr = a.fifo_r + fifo_off;
  const float* fi = a.fifo_i + fifo_off;
  float* fr_out = a.fifo_r_out + fifo_off;
  float* fi_out = a.fifo_i_out + fifo_off;
  float* y = a.out + static_cast<size_t>(c) * mo * H;
  // block input extended by the carried tail: frame j = ext[j*H, j*H + N)
  auto ext = [&](int i) { return i < d ? in_tail[i] : xr[i - d]; };

  for (int i = tid; i < N / 2; i += nt) tw_s[i] = a.tw[i];
  for (int k = tid; k < nb; k += nt) {
    z0r[k] = a.z0r[cb + k];
    z0i[k] = a.z0i[cb + k];
    accr[k] = a.accr[cb + k];
    acci[k] = a.acci[cb + k];
  }
  for (int i = tid; i < a.ring; i += nt) ring[i] = i < d ? a.ola_tail[cd + i] : 0.0f;
  // old FIFO rows that survive the block move to the front of the new one
  for (int i = tid; i < (depth - m) * nb; i += nt) {
    fr_out[i] = fr[static_cast<size_t>(m) * nb + i];
    fi_out[i] = fi[static_cast<size_t>(m) * nb + i];
  }
  __syncthreads();

  // ---- pass A: analysis of the new frames j, j+1
  for (int j = 0; j < m; j += 2) {
    const bool two = j + 1 < m;
    for (int i = tid; i < N; i += nt) {
      const float w = a.win[i];
      z[i] = make_float2(ext(j * H + i) * w, two ? ext((j + 1) * H + i) * w : 0.0f);
    }
    __syncthreads();
    asp::fft_shared(z, N, a.log2n, false, tw_s);
    for (int k = tid; k < nb; k += nt) {
      const int k2 = (N - k) & (N - 1);
      const float2 zk = z[k], zn = z[k2];
      // A = (Z[k] + conj Z[N-k]) / 2, B = (Z[k] - conj Z[N-k]) / 2i
      const float2 s[2] = {make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y)),
                           make_float2(0.5f * (zk.y + zn.y), -0.5f * (zk.x - zn.x))};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e == 1 && !two) break;
        // new frame j+e is row depth - m + j + e of the new FIFO
        const int r = depth - m + j + e;
        if (r >= 0) {
          fr_out[static_cast<size_t>(r) * nb + k] = s[e].x;
          fi_out[static_cast<size_t>(r) * nb + k] = s[e].y;
        }
        if (j + e == a.hit) {
          const float2 u0 = asp::unit_rotor(s[e].x, s[e].y);
          z0r[k] += u0.x;
          z0i[k] += u0.y;
        }
      }
    }
    __syncthreads();
  }

  // ---- pass B: synthesis of the frames u, u+1
  const int p0 = a.i0 * H;
  for (int u = 0; u < mo; u += 2) {
    const bool two = u + 1 < mo;
    for (int k = tid; k < nb; k += nt) {
      float2 syn[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
      float ar = accr[k], ai = acci[k];
      const float zr = z0r[k], zi = z0i[k];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e == 1 && !two) break;
        const size_t s = static_cast<size_t>(a.slots[u + e]);
        const float f = a.fracs[u + e];
        const bool emit = u + e >= a.lo && u + e < a.hi;
        const float s0r = fr_out[s * nb + k], s0i = fi_out[s * nb + k];
        const float s1r = fr_out[(s + 1) * nb + k], s1i = fi_out[(s + 1) * nb + k];
        const float2 rot = emit ? asp::unit_rotor(s1r * s0r + s1i * s0i, s1i * s0r - s1r * s0i)
                                : make_float2(1.0f, 0.0f);
        const float phr = zr * ar - zi * ai, phi = zr * ai + zi * ar;
        const float mag = emit ? (1.0f - f) * hypotf(s0r, s0i) + f * hypotf(s1r, s1i) : 0.0f;
        syn[e] = make_float2(mag * phr, mag * phi);
        const float nr = ar * rot.x - ai * rot.y;
        ai = ar * rot.y + ai * rot.x;
        ar = nr;
      }
      accr[k] = ar;
      acci[k] = ai;
      const int k2 = (N - k) & (N - 1);
      // the inverse real transform ignores the imaginary parts of the DC
      // and Nyquist bins
      const bool edge = k2 == k;
      const float sar = syn[0].x, sai = edge ? 0.0f : syn[0].y;
      const float sbr = syn[1].x, sbi = edge ? 0.0f : syn[1].y;
      // Z = A + iB at k, and its Hermitian partner at N-k
      z[k] = make_float2(sar - sbi, sai + sbr);
      if (!edge) z[k2] = make_float2(sar + sbi, sbr - sai);
    }
    __syncthreads();
    asp::fft_shared(z, N, a.log2n, true, tw_s);
    // overlap-add frame u (re) at [u*H, u*H + N) and frame u+1 (im) one
    // hop later; each thread owns positions, so no two threads add to one
    const int base = u * H;
    for (int v = tid; v < (two ? N + H : N); v += nt) {
      float val = v < N ? z[v].x * a.win[v] : 0.0f;
      if (two && v >= H) val += z[v - H].y * a.win[v - H];
      ring[(base + v) & rmask] += val * inv_n;
    }
    __syncthreads();
    // positions before the next frame's start are complete: emit, free
    for (int v = tid; v < (two ? 2 * H : H); v += nt) {
      const int q = base + v;
      y[q] = ring[q & rmask] * asp::gate_inv_norm(a, p0 + q, d);
      ring[q & rmask] = 0.0f;
    }
    __syncthreads();
  }

  // ---- the new carry
  const int b = m * H, b_out = mo * H;
  for (int i = tid; i < d; i += nt) {
    a.ola_tail_out[cd + i] = ring[(b_out + i) & rmask];
    a.in_tail_out[cd + i] = ext(b + i);
  }
  for (int k = tid; k < nb; k += nt) {
    a.z0r_out[cb + k] = z0r[k];
    a.z0i_out[cb + k] = z0i[k];
    a.accr_out[cb + k] = accr[k];
    a.acci_out[cb + k] = acci[k];
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_stretch_step(const asp::StretchStepArgs* a, int smem_bytes, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(stretch_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  stretch_step_kernel<<<a->channels, kThreads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
