// Whole-file spectral noise gate for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/gate_kernel.py:noise_gate_fused.  Per channel the result equals
// oracle.noise_gate(x, nfft, hop, ...): frames at k*hop, periodic window,
// forward FFT, a hard per-bin mask against the noise floor (an input: the
// wrapper computes it from the first noise_frames frames with plain torch
// on the device, as the TPU package does in XLA outside its kernel),
// optional max-with-decay release along frames, inverse FFT, window,
// overlap-add, times the clamped 1/WOLA norm.  Output length
// nfft + (F-1)*hop; frames past the last whole frame F are never formed.
//
// Design.  It is the gate half of the whole-file FIR -> gate body
// (asp::fir_gate_tiles, chain_device.cuh) with the FIR switched off at
// compile time: the fill functor writes raw samples into the span the
// frames read.  Same two launches as chain_kernel.cu: with release == 0
// one CTA per (channel, tile of MF hops of output), each recomputing the
// nfft/hop-1 frames of halo before its tile, so no CTA reads another's
// result; with release > 0 (a scan over all frames) one CTA per channel
// walking its tiles in order, the OLA spill and the release state in
// shared memory.  Two frames go to one complex FFT as re/im and are
// untangled per bin pair for the mask.
//
// One time shard of the gate (asp_gate_shard) replaces the TPU package's
// kernels/gate_kernel.py:gate_shard_fused.  The input is the shard's l
// samples and the d = nfft-hop samples of its right neighbour's head, the
// floor is the one time shard 0 computed (the caller broadcasts it), and
// only the first `nvalid` of the l/hop frames are analysed: frames whose
// end passes the file's end are never formed, as in the whole-file gate.
// The same kernel runs with the output length decoupled from the frame
// count (asp::shard_geo: l + d samples, the spill included) and no
// 1/WOLA table: the caller adds the spill into its right neighbour and
// divides by the norm at global positions.  Its bound per launch, at a
// shard of 64 x 119808 (+768): 61.7 MB moved (0.018 ms at 3.35 TB/s) and
// 1.53 GFLOP (0.023 ms at 67 TFLOP/s), so operations bound it, as above.
//
// What bounds it on an H100, at 64 channels x 480000 samples, nfft 1024,
// hop 256: 123 MB in and 123 MB out (0.07 ms at 3.35 TB/s); two complex
// 1024-point transforms per frame pair, 5 n log2 n flops each, about
// 51 kflop a frame or 6.1 GFLOP for the 119 000 frames (0.09 ms at
// 67 TFLOP/s; 0.18 ms counting each real frame as a full complex
// transform pair).  So the FFT arithmetic and its shared-memory traffic
// bound it; radix-2 stages (one barrier each) and the halo recompute
// (16 + 3 frames per 16 hops of output) are what this simple design pays.

#include <cuda_runtime.h>

#include "chain_device.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
noise_gate_kernel(const float* __restrict__ x, int n, float* __restrict__ out,
                  const float* __restrict__ noise_floor, const float* __restrict__ win,
                  const float2* __restrict__ tw, const float* __restrict__ inv_tab,
                  asp::ChainGeo g) {
  extern __shared__ float4 smem[];
  const int c = blockIdx.y;
  const float* xc = x + static_cast<size_t>(c) * n;
  const auto fill = [xc, n](float* span, int s, int len) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int gi = s + i;
      span[i] = gi < n ? xc[gi] : 0.0f;
    }
    __syncthreads();
  };
  asp::fir_gate_tiles<false>(g, reinterpret_cast<float*>(smem), c,
                             out + static_cast<size_t>(c) * g.out_len, noise_floor, win,
                             nullptr, tw, inv_tab, fill);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
int asp_noise_gate(const float* x, float* out, const float* noise_floor,
                   const float* win, const float* tw, const float* inv_tab,
                   int channels, int n, int nfft, int log2n, int hop, int nframes,
                   int mf, int sequential, float thresh_gain, float att, float release,
                   int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const asp::ChainGeo g = asp::chain_geo(nfft, log2n, hop, 1, nframes, mf, sequential,
                                         thresh_gain, att, release);
  err = cudaFuncSetAttribute(noise_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sequential ? 1 : g.ntiles, channels);
  noise_gate_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, n, out, noise_floor, win, reinterpret_cast<const float2*>(tw), inv_tab, g);
  return static_cast<int>(cudaGetLastError());
}

// One time shard: x (channels, n) rows of the shard plus its right halo,
// out (channels, n) the un-normalized overlap-add of the first nvalid
// frames (zeros past them).  Same launch as the parallel whole-file gate.
int asp_gate_shard(const float* x, float* out, const float* noise_floor, const float* win,
                   const float* tw, int channels, int n, int nfft, int log2n, int hop,
                   int nvalid, int mf, float thresh_gain, float att, int smem_bytes,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const asp::ChainGeo g = asp::shard_geo(
      asp::chain_geo(nfft, log2n, hop, 1, nvalid, mf, 0, thresh_gain, att, 0.0f), n);
  err = cudaFuncSetAttribute(noise_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.ntiles, channels);
  noise_gate_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, n, out, noise_floor, win, reinterpret_cast<const float2*>(tw), nullptr, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
