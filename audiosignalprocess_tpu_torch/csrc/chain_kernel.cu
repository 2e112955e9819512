// Fused FIR -> spectral noise gate for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/chain_kernel.py:fir_noise_gate_fused.  Per channel the result
// equals oracle.noise_gate(oracle.fir_direct(x, h), nfft, hop, ...):
// causal FIR with zero history by FFT overlap-save, then frames at k*hop,
// periodic window, forward FFT, a hard per-bin mask against the noise
// floor (an input: the wrapper computes it from the filtered signal's
// first frames with plain torch on the device, as the TPU package does
// in XLA outside its kernel), optional max-with-decay release along
// frames, inverse FFT, window, overlap-add, times the clamped 1/WOLA norm.
//
// Design.  The TPU kernel walks a grid that runs in order on one core
// and carries two things from one grid step to the next: the OLA spill
// (the nfft-hop samples a tile's last frames add past its end) and the
// release state.  Blocks on the GPU run in parallel and in no order, so
// neither carry is reproduced in the default launch:
//
// - release == 0: one CTA per (channel, tile of MF hops of output).  A
//   CTA recomputes everything its tile needs from raw input: the
//   nfft/hop-1 frames before the tile that overlap into it (the halo)
//   and the taps-1 samples of FIR history before those.  It writes its
//   tile once; no CTA reads another's result.  This is the same halo
//   recomputation the TPU kernel uses for the FIR, applied to the OLA
//   spill as well.
// - release > 0: the release state s_q = max(m_q, r*s_{q-1}) is a true
//   scan over all frames and cannot be recomputed from a halo.  The same
//   kernel is launched with one CTA per channel that walks its tiles in
//   order, each tile processing only its own MF frames, with the OLA
//   spill and the (nfft/2+1)-bin release state kept in shared memory.
//
// Real transforms go two to a complex FFT: two overlap-save blocks as
// re/im (the taps are real, so the filtered blocks come back as re/im),
// and two gate frames as re/im, untangled per bin pair (k, n-k) for the
// mask and put back together before the inverse.  Everything is float32;
// twiddles and the tap spectrum are computed in float64 on the host.
//
// What bounds it on an H100, at the headline shape (64 channels x
// 480000 samples, 64 taps, nfft 1024, hop 256): device memory moves
// about 123 MB in and 123 MB out, about 0.07 ms at 3.35 TB/s.  The
// arithmetic is about 500 float32 flops per sample with full complex
// 1024-point FFTs (two for the FIR per 961 samples, two for the gate per
// 256-sample hop), about 15 GFLOP in all.  So FFT arithmetic and the
// shared-memory traffic of the butterflies bound it, not device memory.
// This simple design halves the FFT count with the two-for-one packing,
// keeps every intermediate (raw span, filtered span, spectra, OLA tile)
// in shared memory, and pays for it with radix-2 stages (one shared
// memory round trip and one barrier per stage) and the halo recompute
// (MF + nfft/hop - 1 frames and about MF*hop + 2*(nfft-hop) filtered
// samples per MF*hop output samples).  Radix-8 in registers and a
// persistent schedule are later work.

#include <cuda_runtime.h>

#include "fir_device.cuh"

namespace {

constexpr int kThreads = 256;

// Geometry, computed by the Python wrapper (kernels/chain_kernel.py,
// _geometry), which also sizes the dynamic shared memory from the same
// fields in the order the kernel carves it up below.
struct Geo {
  int n;          // input samples per channel
  int nfft;       // N, a power of two
  int log2n;
  int hop;        // H, divides N
  int taps;       // T, T - 1 < N
  int nframes;    // F = 1 + (n - N) / H
  int out_len;    // N + (F - 1) * H
  int mf;         // frames per tile (>= N / H)
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

__device__ __forceinline__ float inv_norm_at(const Geo& g, const float* tab, int p) {
  // tab = [head ramp (d) | one interior period (H) | tail ramp (d)]
  if (p < g.d) return tab[p];
  if (p >= g.out_len - g.d) return tab[g.d + g.hop + p - (g.out_len - g.d)];
  return tab[g.d + p % g.hop];
}

__global__ void __launch_bounds__(kThreads)
fir_noise_gate_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ noise_floor,
                      const float* __restrict__ win,
                      const float2* __restrict__ hf,
                      const float2* __restrict__ tw,
                      const float* __restrict__ inv_tab, Geo g) {
  extern __shared__ float4 smem[];
  const int N = g.nfft, H = g.hop;
  const int nb = N / 2 + 1;
  float2* tw_s = reinterpret_cast<float2*>(smem);  // N/2
  float2* z = tw_s + N / 2;                        // N, the FFT buffer
  float* thr = reinterpret_cast<float*>(z + N);    // nb, floor * gain
  float* rel = thr + nb;                           // nb, release state
  float* acc = rel + nb;                           // tile + d, OLA
  float* span = acc + g.tile + g.d;                // raw -> filtered span

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c = blockIdx.y;
  const float* xc = x + static_cast<size_t>(c) * g.n;
  float* oc = out + static_cast<size_t>(c) * g.out_len;

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
      // holds raw x[y0 - (T-1) + r]; block k reads span[k*blk, +N) and
      // its filtered output overwrites span[k*blk, +blk), which no later
      // block reads, so span[m] ends up holding y[y0 + m].
      const int y0 = qa * H;
      const int len = (qb - 1) * H + N - y0;
      const int nblk = (len + g.blk - 1) / g.blk;
      const int rlen = nblk * g.blk + g.taps - 1;
      const int xs = y0 - (g.taps - 1);
      for (int i = tid; i < rlen; i += nt) {
        const int gi = xs + i;
        span[i] = (gi >= 0 && gi < g.n) ? xc[gi] : 0.0f;
      }
      __syncthreads();
      const auto raw = [span](int j) { return span[j]; };
      for (int k = 0; k < nblk; k += 2) {
        const bool two = k + 1 < nblk;
        asp::os_block_pair(z, raw, k, two, g.blk, N, g.log2n, hf, tw_s);
        float* o = span + k * g.blk;
        for (int i = tid; i < g.blk; i += nt) {
          const float2 v = z[g.taps - 1 + i];
          o[i] = v.x * g.inv_n;
          if (two) o[g.blk + i] = v.y * g.inv_n;
        }
        __syncthreads();
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
        asp::fft_shared(z, N, g.log2n, false, tw_s);
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
        asp::fft_shared(z, N, g.log2n, true, tw_s);
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
      if (gp < g.out_len) oc[gp] = acc[p] * inv_norm_at(g, inv_tab, gp);
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

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_fir_noise_gate(const float* x, float* out, const float* noise_floor,
                       const float* win, const float* hf, const float* tw,
                       const float* inv_tab, int channels, int n, int nfft,
                       int log2n, int hop, int taps, int nframes, int mf,
                       int sequential, float thresh_gain,
                       float att, float release, int smem_bytes, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geo g;
  g.n = n;
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
  err = cudaFuncSetAttribute(fir_noise_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sequential ? 1 : g.ntiles, channels);
  fir_noise_gate_kernel<<<grid, kThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      x, out, noise_floor, win, reinterpret_cast<const float2*>(hf),
      reinterpret_cast<const float2*>(tw), inv_tab, g);
  return static_cast<int>(cudaGetLastError());
}

const char* asp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
