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
// Design.  It is the batched register body of the whole-file chains
// (asp::fir_gate_regs, chain_regs_device.cuh) with the FIR switched off at
// compile time (kFir false): the fill functor writes raw samples into the
// span the frames read, which holds only the tile's frames.  Same two
// launches as chain_kernel.cu: with release == 0 one CTA per (channel,
// tile of mf hops of output), each recomputing the nfft/hop-1 frames of
// halo before its tile, so no CTA reads another's result; with release > 0
// (a scan over all frames) one CTA per channel walking its tiles in order,
// the overlap-add spill and the release state in shared memory.  A CTA
// runs B = 4096/nfft transforms at once (4 at nfft 1024), two frames to a
// transform as re/im, on fft_regs.cuh's Stockham passes in registers
// (plan regs_pass_plan: 4 + 4 + 2 stages each way at nfft 1024); the
// untangle, mask and retangle of each bin pair sit in the registers of the
// merged pass (the forward's last and the inverse's first), and each
// transform's warps meet at a named barrier of their own.  The tile
// (regs_geometry in kernels/gate_kernel.py) is the largest whole number of
// gate batches that keeps 2 CTAs an SM: 29 hops at nfft 1024, hop 256
// (32 frames, four batches of 8), where the radix-2 body it replaces ran
// 16-hop tiles of one 1024-point transform at a time in shared memory,
// ten stages with a CTA barrier each.  At nfft 8192 a batch is one
// transform of 512 threads and the CTA has one exchange buffer (one CTA
// an SM) and its span in device memory; past 8192 the wrapper raises
// (SMEM_LIMIT).
//
// One time shard of the gate (asp_gate_shard) replaces the TPU package's
// kernels/gate_kernel.py:gate_shard_fused.  The input is the shard's l
// samples and the d = nfft-hop samples of its right neighbour's head, the
// floor is the one time shard 0 computed (the caller broadcasts it), and
// only the first `nvalid` of the l/hop frames are analysed: frames whose
// end passes the file's end are never formed, as in the whole-file gate.
// The same kernel runs with the output length decoupled from the frame
// count (asp::shard_geo: l + d samples, the spill included, 0 past the
// last frame's end) and no 1/WOLA table: the caller adds the spill into
// its right neighbour and divides by the norm at global positions.  Its
// bound per launch, at a shard of 64 x 119808 (+768): 61.7 MB moved
// (0.018 ms at 3.35 TB/s) and 1.53 GFLOP (0.023 ms at 67 TFLOP/s), so
// operations bound it, as below.
//
// What bounds it on an H100, at 64 channels x 480000 samples, nfft 1024,
// hop 256: 123 MB in and 123 MB out (0.07 ms at 3.35 TB/s); two complex
// 1024-point transforms per frame pair, 5 n log2 n flops each, about
// 51 kflop a frame or 6.1 GFLOP for the 119 000 frames (0.09 ms at
// 67 TFLOP/s).  So the FFT arithmetic bounds it; what the body pays above
// that is the exchange of points between passes through shared memory,
// the overlap-add pass, and the halo (3 frames recomputed a 29-hop tile).

#include <cuda_runtime.h>

#include "chain_regs_device.cuh"

namespace {

template <int R, int RS, bool kRelease, int T>
__global__ void __launch_bounds__(T, 2 * asp::kRegsThreads / T)
noise_gate_kernel(const float* __restrict__ x, int n, float* __restrict__ out,
                  const float* __restrict__ noise_floor, const float* __restrict__ win,
                  const float2* __restrict__ twf, const float2* __restrict__ twi,
                  const float* __restrict__ inv_tab, asp::ChainGeo g, float* span_rows) {
  extern __shared__ float4 smem[];
  const int c = blockIdx.y;
  const float* xc = x + static_cast<size_t>(c) * n;
  const auto fill = [xc, n](float* span, int s, int len, float*) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int gi = s + i;
      span[i] = gi < n ? xc[gi] : 0.0f;
    }
    __syncthreads();
  };
  asp::fir_gate_regs<R, RS, kRelease, false, T>(g, reinterpret_cast<float*>(smem), c,
                                             out + static_cast<size_t>(c) * g.out_len,
                                             noise_floor, win, nullptr, twf, twi, inv_tab,
                                             span_rows, fill);
}

using Kernel = void (*)(const float*, int, float*, const float*, const float*, const float2*,
                        const float2*, const float*, asp::ChainGeo, float*);

template <int R, int RS, bool kRelease, int T>
struct NoiseGate {
  static Kernel fn() { return noise_gate_kernel<R, RS, kRelease, T>; }
};

int launch(const asp::ChainGeo& g, int channels, const float* x, int n, float* out,
           const float* noise_floor, const float* win, const float* twf, const float* twi,
           const float* inv_tab, float* span_rows, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Kernel kernel = asp::regs_kernel_for<NoiseGate>(g.nfft, g.sequential);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.sequential ? 1 : g.ntiles, channels);
  kernel<<<grid, asp::regs_threads(g.nfft), smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, n, out, noise_floor, win, reinterpret_cast<const float2*>(twf),
      reinterpret_cast<const float2*>(twi), inv_tab, g, span_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t).  Returns cudaGetLastError() after
// the launch: 0 on success.  Nothing is synchronized or allocated here.
// span_rows: at nfft 8192 the CTAs' spans (fir_gate_regs), else null.
int asp_noise_gate(const float* x, float* out, const float* noise_floor,
                   const float* win, const float* twf, const float* twi, const float* inv_tab,
                   float* span_rows, int channels, int n, int nfft, int log2n, int hop,
                   int nframes, int mf, int sequential, float thresh_gain, float att,
                   float release, int smem_bytes, int device, void* stream) {
  const asp::ChainGeo g = asp::chain_geo(nfft, log2n, hop, 1, nframes, mf, sequential,
                                         thresh_gain, att, release);
  return launch(g, channels, x, n, out, noise_floor, win, twf, twi, inv_tab, span_rows,
                smem_bytes, device, stream);
}

// One time shard: x (channels, n) rows of the shard plus its right halo,
// out (channels, n) the un-normalized overlap-add of the first nvalid
// frames (zeros past them).  Same launch as the parallel whole-file gate.
int asp_gate_shard(const float* x, float* out, const float* noise_floor, const float* win,
                   const float* twf, const float* twi, float* span_rows, int channels, int n,
                   int nfft, int log2n, int hop, int nvalid, int mf, float thresh_gain,
                   float att, int smem_bytes, int device, void* stream) {
  const asp::ChainGeo g = asp::shard_geo(
      asp::chain_geo(nfft, log2n, hop, 1, nvalid, mf, 0, thresh_gain, att, 0.0f), n);
  return launch(g, channels, x, n, out, noise_floor, win, twf, twi, nullptr, span_rows,
                smem_bytes, device, stream);
}

// The instantiation for nfft and the launch: info = {registers a thread,
// local memory bytes a thread (spills), resident CTAs an SM at smem_bytes}.
int asp_noise_gate_info(int nfft, int sequential, int smem_bytes, int device, int* info) {
  const Kernel kernel = asp::regs_kernel_for<NoiseGate>(nfft, sequential);
  return asp::regs_kernel_info(kernel, asp::regs_threads(nfft), smem_bytes, device, info);
}

}  // extern "C"
