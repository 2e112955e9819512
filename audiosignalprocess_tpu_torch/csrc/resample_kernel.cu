// Polyphase rational resampler for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel
// kernels/resample_kernel.py:resample_mac.  Per channel the result equals
// ops/resample.resample_poly(x, up, down, h, zero_phase, history): output
// j = sum_k h[p + up*k] * raw[m - k] with j*down + delay = m*up + p, the
// history (or zeros) before x and zeros past it (resample_device.cuh).
//
// Design.  The TPU kernel turns the resampler into one dense matmul per
// tile of output cycles (a window of R*down raw samples times a static
// (R*down, up) phase matrix), because its matrix unit wants dense
// operands; that costs about R*down/nk = 8x the multiply-adds at 160/147.
// Here the polyphase MAC runs on the FP32 pipes:
//
// - A super-cycle is S = k*up outputs (k = 1, or lcm(up, kQ)/up where up <
//   kQ, times what gives it 8 groups of kQ = 8 where up < 64:
//   resample_kernel.MIN_GROUPS), which read raw samples D = k*down apart
//   from one super-cycle to the next and repeat the same phases.  A tile is 32 kP super-cycles:
//   lane l takes super-cycles l + 32 p (p < kP) and computes kQ = 8
//   consecutive outputs (a group) of each, so the warp's lanes share their
//   phases: a tap read is one broadcast, and feeds kP outputs a lane.
// - Each group walks the union of its outputs' windows once, cols columns
//   (a multiple of 4): column c's raw sample is loaded once into a register
//   and feeds all kQ outputs, output i with the tap table's entry
//   tab[i][c] = bank[p_i][c - o_i] (o_i: where output i's window starts in
//   the group's union, zero outside its nk taps).  An output's fmaf chain
//   thus runs over its taps in order, t = 0 .. nk-1, as the retired
//   kernel's did, with fmaf(0, w, acc) before the first (acc stays +0) and
//   after the last (acc unchanged): bit for bit the plain fmaf chain on
//   finite inputs, the same products as the TPU kernel's zero-padded phase
//   matrix.  As there, an Inf or NaN raw sample also reaches the outputs
//   of its group whose taps miss it (0 * Inf is NaN): up to cols - nk
//   neighbours of each output it feeds read NaN, where the plain nk-tap
//   chain keeps them finite.
// - The CTA builds that tap table once, for its range of groups, and then
//   walks a strip of tiles of one channel (resample_kernel.resample_geometry:
//   one wave of 2 CTAs an SM at the headline, the bank read 256 times where
//   the retired kernel read it 30016 times; where a channel has few tiles,
//   the groups are split over CTAs instead).  The raw window arrives by
//   cp.async (16-byte copies where x's words line up) in one buffer; the
//   MAC of another CTA on the SM hides the copy (a second buffer measured
//   slower at the headline, where it leaves one CTA an SM).
// - The window holds a row of columns a super-cycle at stride rs; rs is odd,
//   so a warp's 32 reads hit 32 banks: either the raw samples themselves
//   where D is odd (rows overlap, rs = D, one contiguous copy), or a copied
//   row a super-cycle padded to an odd length.
// - The outputs go to shared memory, a row a super-cycle (16-byte writes
//   at a stride of an odd count of 16-byte words), and then to y in one
//   bulk copy a row (cp.async.bulk, run in the background while the next
//   tile's MAC starts), or the warp's coalesced stores where a row is not
//   whole 16-byte words of y: lanes storing their own 32-byte runs 640 bytes
//   apart wrote y at under a third of the card's rate.  A CTA of a single
//   tile (a stream's block) stores straight from registers instead: no
//   next tile's MAC would hide the row buffer's barrier and bulk copies.
// - Phases and newest raw indices come from one 64-bit division a thread
//   and CTA, then are stepped forward; no output divides.
// - Where the table and window of kQ = 8 outputs a thread do not fit in
//   shared memory (filters far longer than the prototype), the same body
//   runs one output a thread (kQ = 1): every ratio and filter the retired
//   kernel took still launches.
//
// What bounds it on an H100: at the headline (64 channels, 441000 ->
// 480000 samples) it moves about 113 MB in and 123 MB out, 0.0704 ms at
// 3.35 TB/s, and does 1.3 GFLOP of useful fmaf (1.7 with the table's
// zeros, 0.026 ms at 67 TFLOP/s).  A warp's tap broadcast costs shared
// memory one wavefront a tap whatever its width (a 16-byte broadcast
// measured as slow as four 4-byte ones), so a group of 8 outputs costs 28
// window and 224 tap wavefronts: 0.12 ms over the card at one super-cycle
// a lane (measured: the MAC alone, without copies), half that at two.  At
// two the whole file takes 0.12 ms of device time, 1.7x the bytes bound
// (PERF.md).

#include <cuda_runtime.h>

#include "chain_regs_device.cuh"  // regs_kernel_info

namespace {

constexpr int kLanes = 32;       // a warp's lanes: lane l takes super-cycles l + 32 p (LANES)
constexpr int kMaxThreads = 320;

// The launch's geometry: resample_kernel.GEO_FIELDS, in this order.
struct ResMacGeo {
  int x_ld, hn, n, nout;      // x's row stride, history and input length, outputs
  int up, down, nk, delay;    // the reduced ratio, taps a phase, zero-phase advance
  int cyc, raw;               // a super-cycle's outputs (S) and raw samples (D)
  int groups, range, splits;  // groups of kQ outputs a super-cycle, a CTA's, CTAs along them
  int cols;                   // columns of a group's walk (a multiple of 4)
  int rs, wl, rows;           // window row stride, floats a buffer, 1: a copied row a super-cycle
  int os;                     // out_s's row stride (range * kQ, padded: writes conflict-free);
                              // 0: no out_s, a CTA of one tile stores from registers
  int strip, tiles;           // tiles a CTA walks, tiles a channel
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  // src-size 0 fills the word with zero and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory before the
// async proxy's reads (bulk stores) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared memory -> device memory, `bytes` (a multiple of 16, both ends
// 16-byte aligned), in this thread's current bulk group.
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until this thread's committed bulk stores have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// (x's word index of raw sample r) mod 4: where raw r goes in a contiguous
// window so that 16-byte groups of words line up with x's
__device__ __forceinline__ int word_align(const float* xc, int r) {
  return static_cast<int>((reinterpret_cast<size_t>(xc) / 4 + static_cast<size_t>(r)) & 3);
}

// floor((q*down + delay) / up): the newest raw sample output q reads
__device__ __forceinline__ int newest(const ResMacGeo& g, int q) {
  return static_cast<int>((static_cast<long long>(q) * g.down + g.delay) / g.up);
}

// raw sample r of [hist (hn) | x (n)] (zero elsewhere) into dst, asynchronously
__device__ __forceinline__ void stage_raw(float* dst, const ResMacGeo& g, const float* xc,
                                          const float* hc, int r) {
  const bool in_x = r >= 0 && r < g.n;
  const bool in_h = hc != nullptr && r < 0 && r >= -g.hn;
  cp_async4(dst, in_x ? xc + r : (in_h ? hc + g.hn + r : xc), in_x || in_h);
}

template <int kQ, int kP>
__global__ void __launch_bounds__(kMaxThreads)
resample_mac_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                    float* __restrict__ y, const float* __restrict__ bank, ResMacGeo g) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int c = blockIdx.y;
  const int g0 = (blockIdx.x % g.splits) * g.range;  // the CTA's groups [g0, g0 + ng)
  const int ng = min(g.range, g.groups - g0);
  const int t0 = (blockIdx.x / g.splits) * g.strip;  // its tiles [t0, t1)
  const int t1 = min(g.tiles, t0 + g.strip);
  float* tab = reinterpret_cast<float*>(smem4);                  // (range * kQ, cols)
  int* col_s = reinterpret_cast<int*>(tab + g.range * kQ * g.cols);  // a group's first column
  float* win = reinterpret_cast<float*>(col_s + ((g.range + 3) & ~3));  // wl: a tile's window
  float* out_s = win + g.wl;  // (kRows, os): a tile's outputs, a super-cycle a row

  constexpr int kRows = kLanes * kP;  // super-cycles a tile: lane l takes l + 32 p, p < kP
  // column 0 of a row is raw sample s*D + r_lo of super-cycle s
  const int m0 = newest(g, g0 * kQ);
  const int r_lo = m0 - (g.nk - 1);
  for (int i = tid; i < ng; i += nt) col_s[i] = newest(g, (g0 + i) * kQ) - m0;
  __syncthreads();
  const int lsub = col_s[ng - 1] + g.cols;  // columns a row holds

  const float* xc = x + static_cast<size_t>(c) * g.x_ld;
  const float* hc = hist ? hist + static_cast<size_t>(c) * g.hn : nullptr;
  const auto stage = [&](int t) {  // tile t's raw window into win
    const int base = t * kRows * g.raw + r_lo;
    if (g.rows) {
      for (int row = warp; row < kRows; row += nw) {
        const int rb = base + row * g.raw;
        for (int col = lane; col < lsub; col += 32) {
          stage_raw(win + row * g.rs + col, g, xc, hc, rb + col);
        }
      }
    } else {  // word a + e holds raw base + e: 16-byte copies where a word group lies in x
      const int a = word_align(xc, base);
      const int words = (kRows - 1) * g.raw + lsub + a;
      for (int v = 4 * tid; v < words; v += 4 * nt) {
        const int r = base + v - a;
        if (r >= 0 && r + 4 <= g.n) {
          cp_async16(win + v, xc + r);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) stage_raw(win + v + u, g, xc, hc, r + u);
        }
      }
    }
    cp_async_commit();
  };
  stage(t0);

  // the tap table: slot i is output g0*kQ + i of a super-cycle; a thread's
  // slots step by nt outputs from one division
  {
    const long long pos = static_cast<long long>(g0 * kQ + tid) * g.down + g.delay;
    int m = static_cast<int>(pos / g.up);
    int p = static_cast<int>(pos - static_cast<long long>(m) * g.up);
    const long long st = static_cast<long long>(nt) * g.down;
    const int step_m = static_cast<int>(st / g.up);
    const int step_p = static_cast<int>(st - static_cast<long long>(step_m) * g.up);
    for (int i = tid; i < ng * kQ; i += nt) {
      const bool valid = g0 * kQ + i < g.cyc;  // a last group may run past the super-cycle
      const int o = m - m0 - col_s[i / kQ];
      const float* b = bank + static_cast<size_t>(p) * g.nk;
      float* row = tab + i * g.cols;
      for (int col = 0; col < g.cols; ++col) {
        const int t = col - o;
        row[col] = valid && t >= 0 && t < g.nk ? b[t] : 0.0f;
      }
      m += step_m;
      p += step_p;
      if (p >= g.up) {
        p -= g.up;
        ++m;
      }
    }
  }

  const int c4 = g.cols >> 2;
  const int len = min(ng * kQ, g.cyc - g0 * kQ);  // a row's outputs
  float* yc = y + static_cast<size_t>(c) * g.nout;
  for (int t = t0; t < t1; ++t) {
    // the last tile's MAC has read win (the barrier before its stores; a
    // CTA without out_s walks one tile)
    if (t > t0) stage(t);
    cp_async_wait_all();
    if (lane == 0) bulk_wait_read();  // the last tile's stores have read out_s
    __syncthreads();
    const float* w0 = win + lane * g.rs + (g.rows ? 0 : word_align(xc, t * kRows * g.raw + r_lo));
    for (int gi = warp; gi < ng; gi += nw) {
      const float* w = w0 + col_s[gi];
      const float4* b4 = reinterpret_cast<const float4*>(tab + gi * kQ * g.cols);
      float acc[kP][kQ];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
#pragma unroll
        for (int i = 0; i < kQ; ++i) acc[p][i] = 0.0f;
      }
#pragma unroll 2
      for (int k = 0; k < c4; ++k) {
        float u[kP][4];  // the chunk's 4 columns of each of the lane's super-cycles
#pragma unroll
        for (int p = 0; p < kP; ++p) {
#pragma unroll
          for (int v = 0; v < 4; ++v) u[p][v] = w[p * kLanes * g.rs + 4 * k + v];
        }
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const float4 h = b4[i * c4 + k];  // a warp's broadcast feeds kP outputs a lane
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            acc[p][i] = fmaf(h.x, u[p][0], acc[p][i]);
            acc[p][i] = fmaf(h.y, u[p][1], acc[p][i]);
            acc[p][i] = fmaf(h.z, u[p][2], acc[p][i]);
            acc[p][i] = fmaf(h.w, u[p][3], acc[p][i]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (g.os == 0) {  // a CTA of one tile: its outputs straight from registers
          const int q0 = (g0 + gi) * kQ;
          const int j0 = (t * kRows + p * kLanes + lane) * g.cyc + q0;
          const int count = min(min(kQ, g.cyc - q0), g.nout - j0);
          float* yo = yc + j0;
          if (kQ % 4 == 0 && count == kQ && (reinterpret_cast<size_t>(yo) & 15) == 0) {
#pragma unroll
            for (int i = 0; i < kQ; i += 4) {
              *reinterpret_cast<float4*>(yo + i) =
                  make_float4(acc[p][i], acc[p][i + 1], acc[p][i + 2], acc[p][i + 3]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < kQ; ++i) {
              if (i < count) yo[i] = acc[p][i];
            }
          }
          continue;
        }
        float* o = out_s + (p * kLanes + lane) * g.os + gi * kQ;
        if (kQ % 4 == 0) {
#pragma unroll
          for (int i = 0; i < kQ; i += 4) {
            *reinterpret_cast<float4*>(o + i) =
                make_float4(acc[p][i], acc[p][i + 1], acc[p][i + 2], acc[p][i + 3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kQ; ++i) o[i] = acc[p][i];
        }
      }
    }
    if (g.os == 0) continue;
    fence_proxy_async();  // the outputs, seen by the bulk stores
    __syncthreads();
    // a super-cycle's run of the CTA's outputs a row: one bulk store where
    // it is whole 16-byte words of y, else the warp's coalesced stores
    for (int row = warp; row < kRows; row += nw) {
      const int j0 = (t * kRows + row) * g.cyc + g0 * kQ;
      const int cnt = min(len, g.nout - j0);
      float* dst = yc + j0;
      if (cnt <= 0) continue;
      if ((cnt & 3) == 0 && ((row * g.os) & 3) == 0 && (reinterpret_cast<size_t>(dst) & 15) == 0) {
        if (lane == 0) bulk_store(dst, out_s + row * g.os, 4 * cnt);
      } else {
        for (int col = lane; col < cnt; col += 32) dst[col] = out_s[row * g.os + col];
      }
    }
    if (lane == 0) bulk_commit();
  }
  if (lane == 0) bulk_wait_read();  // out_s outlives the CTA's stores' reads
}

template <int kQ, int kP>
int launch(const float* x, const float* hist, float* y, const float* bank, const ResMacGeo& g,
           int channels, int threads, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(resample_mac_kernel<kQ, kP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.tiles + g.strip - 1) / g.strip * g.splits, channels);
  resample_mac_kernel<kQ, kP><<<grid, threads, smem_bytes, stream>>>(x, hist, y, bank, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) with `geo` (resample_kernel.GEO_FIELDS,
// host memory), `q` outputs and `p` super-cycles a thread ((8, 2), (8, 1)
// or (1, 1)) and `threads` threads a CTA.  Returns cudaGetLastError() after
// the launch: 0 on success; another (q, p) is cudaErrorInvalidValue.
// Nothing is synchronized or allocated here.
int asp_resample_mac(const float* x, const float* hist, float* y, const float* bank,
                     const int* geo, int q, int p, int channels, int threads, int smem_bytes,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ResMacGeo g = *reinterpret_cast<const ResMacGeo*>(geo);
  const auto s = static_cast<cudaStream_t>(stream);
  if (q == 8 && p == 2) return launch<8, 2>(x, hist, y, bank, g, channels, threads, smem_bytes, s);
  if (q == 8 && p == 1) return launch<8, 1>(x, hist, y, bank, g, channels, threads, smem_bytes, s);
  if (q == 1 && p == 1) return launch<1, 1>(x, hist, y, bank, g, channels, threads, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// info = {registers a thread, local memory bytes a thread (spills),
// resident CTAs an SM at `threads` and smem_bytes} of the (q, p) instance.
int asp_resample_mac_info(int q, int p, int threads, int smem_bytes, int device, int* info) {
  if (q == 8 && p == 2) {
    return asp::regs_kernel_info(resample_mac_kernel<8, 2>, threads, smem_bytes, device, info);
  }
  if (q == 8 && p == 1) {
    return asp::regs_kernel_info(resample_mac_kernel<8, 1>, threads, smem_bytes, device, info);
  }
  if (q == 1 && p == 1) {
    return asp::regs_kernel_info(resample_mac_kernel<1, 1>, threads, smem_bytes, device, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
