// Standalone batched FFTs for Hopper (sm_90a): complex, real, inverse real.
//
// Replaces the TPU package's Pallas kernels kernels/fft_kernel.py:
// fft_stockham_lanes (batched complex FFT), rfft_stockham (even/odd pack,
// n/2-point FFT, untangle, Nyquist bin) and irfft_stockham (the inverse,
// scaled 1/n).  Conventions of the package's ops/fft.py: natural order in
// and out, forward X[k] = sum_j x[j] exp(-2 pi i j k / n), the complex
// transform unnormalized both ways; irfft ignores the imaginary parts of
// bins 0 and n/2, as torch.fft.irfft does.
//
// Design.  Self-sorting Stockham radix-2 stages: stage s views a row as
// (2^s, R) and writes u + w v, u - w v of each segment's halves to the
// (2^(s+1), R/2) view of the other buffer, so the result comes out in
// natural order with no bit-reversal pass.  A CTA stages its rows in
// shared memory (twiddles, then two ping-pong buffers of m complex points
// per row, m the transform length), runs the log2(m) stages there with one
// barrier each, and writes its rows once; short transforms take several
// rows per CTA (ROW_POINTS in kernels/fft_kernel.py) so each stage still
// has a few hundred butterflies.  A transform too long for shared memory
// runs the same stages on ping-pong buffers in device memory, one row per
// CTA.  The TPU kernels' transposes to a batch-in-lanes layout and their
// two-pass reversal trick (a Mosaic limitation) do not carry over: a
// thread reads Z[(n/2 - k) mod n/2] from shared memory directly.  The
// twiddles exp(-2 pi i k / n) come from a float64 host table; the
// half-size transforms of the real kernels read it at stride 2, their
// untangle at stride 1.
//
// What bounds it on an H100: at 4096 rows x 1024 points a complex
// transform moves 67 MB (20 us at 3.35 TB/s) and does 5 n log2 n flops a
// row (0.2 GFLOP, 3 us at 67 TFLOP/s), so device memory bounds it, and
// every byte is read and written once.  This simple design pays a shared
// memory round trip and a barrier per radix-2 stage; radix-4/8 stages in
// registers are later work.
//
// The other complex transforms of the package's impl registry, same
// planar contract, same row staging (shared memory, or device-memory
// ping-pong buffers for rows too long for it), same host float64 tables:
//
// - fft_fourstep (replaces kernels/fft_kernel.py fft_fourstep): the
//   four-step factorization n = n1 n2, n2 = min(128, n), of the row viewed
//   as the grid X[a][b] = x[a n2 + b]: n1-point DFTs down the columns,
//   the twiddle W_n^{c b}, n2-point DFTs along the rows, the output
//   transposed, T[d][c] = S[n1 d + c].  The TPU kernel runs the DFTs as
//   matrix-unit products; here both are dense products in float32 FMAs on
//   the SM's cores: the n1-side coefficients W_n1^{a c} = W_n^{(a c mod n1)
//   n2} and the twiddle from the n/2-point table in shared memory, the
//   n2 x n2 table read through L1 (128 KB at n2 = 128: too large to stage
//   beside the rows).  Each thread of the row products holds four grid
//   rows of one output column, so a table entry read once serves four
//   MACs and the grid values are warp broadcasts.  What bounds it: it does
//   8 n (n1 + n2) flops a row against the FFT's 5 n log2 n (at 4096 x
//   1024: 4.6 GFLOP, 69 us at 67 TFLOP/s, against 20 us of bytes), so
//   its arithmetic bounds it; the TPU's bf16x3 split does not carry over.
// - fft_radix2_lanes (replaces fft_radix2_lanes): the classic C loop,
//   the bit reversal fused into the load, then all log2 n decimation-in-
//   time stages in place, twiddle exp(sign i pi p / m) at half-size m read
//   from the n/2-point table (the TPU kernel computes it with f32 cos/sin).
// - fft_radix2_stages (replaces fft_radix2_stages, which the TPU ran only
//   in interpret mode): the same stages, twiddles read from the stacked
//   (log2 n, n/2) per-stage table of the sign asked for.
// - fft_pease_lanes (replaces fft_pease_lanes): log2 n identical
//   constant-geometry stages over ping-pong buffers, u = A[k], v =
//   A[k + n/2] -> B[2k] = u + v, B[2k+1] = (u - v) w_s[k] with w_s[k] =
//   exp(sign 2 pi i ((k >> s) << s) / n), one rolled stage body; the
//   stages leave the result in bit-reversed order, and the store reads it
//   through __brev (the TPU package gathers it in XLA afterwards).
// Like the Stockham kernel, the three butterfly kernels move every byte
// once and pay a shared-memory pass and a barrier per stage.

#include <cuda_runtime.h>

#include "fft_device.cuh"

namespace asp {

// The kernels' arguments; kernels/fft_kernel.py (FftArgs) mirrors it.
struct FftArgs {
  const float* in_r;   // complex: re plane (B, n); rfft: x (B, n); irfft: re (B, n/2+1)
  const float* in_i;   // complex: im plane; rfft: unused; irfft: im (B, n/2+1)
  float* out_r;        // complex: re (B, n); rfft: re (B, n/2+1); irfft: y (B, n)
  float* out_i;        // complex: im (B, n); rfft: im (B, n/2+1); irfft: unused
  const float* tw;     // n/2 twiddles exp(-2 pi i k / n) as (re, im) pairs
  float* scratch;      // (B, 2 m) complex ping-pong buffers in device memory, or null
  const float* table;  // fft_fourstep: the n2 x n2 forward DFT table; fft_radix2_stages:
                       // the (log2 n, n/2) stage table of `sign`; null for the others
  int batch;           // B rows
  int n;               // the row length the caller sees
  int sign;            // complex transform: -1 forward, +1 inverse
  int rows;            // rows per CTA
};

}  // namespace asp

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int log2i(int m) { return __ffs(m) - 1; }

// The two ping-pong buffers and the twiddles of this CTA's rows: in shared
// memory after the twiddles are copied there, or the rows' slices of the
// scratch buffers and the table in device memory.  The twiddles are
// ready on return; the caller fills `x` and then synchronizes.
struct Bufs {
  float2* x;
  float2* y;
  const float2* tw;
};

__device__ Bufs setup(const asp::FftArgs& a, float4* smem, int m) {
  const float2* tw_g = reinterpret_cast<const float2*>(a.tw);
  if (a.scratch != nullptr) {
    float2* x = reinterpret_cast<float2*>(a.scratch) +
                static_cast<size_t>(blockIdx.x) * a.rows * 2 * m;
    return {x, x + m, tw_g};
  }
  float2* tw_s = reinterpret_cast<float2*>(smem);
  for (int i = threadIdx.x; i < a.n / 2; i += blockDim.x) tw_s[i] = tw_g[i];
  __syncthreads();  // irfft reads the twiddles while it fills x
  float2* x = tw_s + a.n / 2;
  return {x, x + a.rows * m, tw_s};
}

// Load this CTA's `rows` rows of m points into x, natural order, and zero
// the rest of its a.rows rows; `rev` bit-reverses the order within a row.
__device__ void load_rows(const asp::FftArgs& a, float2* x, int m, int rows, bool rev) {
  const int log2m = log2i(m);
  const size_t base = static_cast<size_t>(blockIdx.x) * a.rows * m;
  for (int i = threadIdx.x; i < a.rows * m; i += blockDim.x) {
    const int j = i & (m - 1);
    const int dst = rev ? (i - j) + static_cast<int>(__brev(static_cast<unsigned>(j)) >>
                                                     (32 - log2m))
                        : i;
    x[dst] = i < rows * m ? make_float2(a.in_r[base + i], a.in_i[base + i])
                          : make_float2(0.0f, 0.0f);
  }
}

// Store this CTA's rows from z; `rev` reads each row in bit-reversed order.
__device__ void store_rows(const asp::FftArgs& a, const float2* z, int m, int rows, bool rev) {
  const int log2m = log2i(m);
  const size_t base = static_cast<size_t>(blockIdx.x) * a.rows * m;
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
    const int j = i & (m - 1);
    const int src = rev ? (i - j) + static_cast<int>(__brev(static_cast<unsigned>(j)) >>
                                                     (32 - log2m))
                        : i;
    a.out_r[base + i] = z[src].x;
    a.out_i[base + i] = z[src].y;
  }
}

// The log2(m) Stockham radix-2 stages over `rows` rows of m points, from
// `src` through `dst` and back, the twiddle exp(sign i pi l / 2^s) read as
// tw[l << (tw_log2 - 1 - s)] from a table of 2^tw_log2 points.  Every
// thread calls it; it returns the buffer holding the result after a
// barrier.
__device__ float2* stockham(float2* src, float2* dst, int m, int rows, bool inverse,
                            const float2* tw, int tw_log2) {
  const int log2m = log2i(m);
  const int half = m >> 1;
  const int total = rows * half;
  for (int s = 0; s < log2m; ++s) {
    const int shift = log2m - 1 - s;  // log2 of the half segment R/2
    const int tw_shift = tw_log2 - 1 - s;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int row = t >> (log2m - 1);
      const int bf = t & (half - 1);
      const int l = bf >> shift;
      const int i0 = (l << (shift + 1)) + (bf & ((1 << shift) - 1));
      const float2* a = src + row * m;
      float2* b = dst + row * m;
      float2 w = tw[l << tw_shift];
      if (inverse) w.y = -w.y;
      const float2 u = a[i0];
      const float2 v = asp::cmul(a[i0 + (1 << shift)], w);
      b[bf] = make_float2(u.x + v.x, u.y + v.y);
      b[bf + half] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

__global__ void __launch_bounds__(kThreads) fft_stockham_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  const int m = a.n;
  const int row0 = blockIdx.x * a.rows;
  const int rows = min(a.rows, a.batch - row0);
  const Bufs bf = setup(a, smem, m);
  load_rows(a, bf.x, m, rows, false);
  __syncthreads();
  store_rows(a, stockham(bf.x, bf.y, m, rows, a.sign > 0, bf.tw, log2i(m)), m, rows, false);
}

__global__ void __launch_bounds__(kThreads) rfft_stockham_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  const int m = a.n / 2;
  const int row0 = blockIdx.x * a.rows;
  const int rows = min(a.rows, a.batch - row0);
  const Bufs bf = setup(a, smem, m);
  // pack z[j] = x[2j] + i x[2j+1]: row r, point j is x[(row0 + r) n + 2j]
  const float* x = a.in_r + static_cast<size_t>(row0) * a.n;
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x)
    bf.x[i] = make_float2(x[2 * i], x[2 * i + 1]);
  __syncthreads();
  const float2* z = stockham(bf.x, bf.y, m, rows, false, bf.tw, log2i(a.n));
  // untangle X[k] = E[k] + w^k O[k], E = (Z[k] + conj Z[-k])/2,
  // O = -i (Z[k] - conj Z[-k])/2; X[m] = Re Z[0] - Im Z[0]
  const size_t out = static_cast<size_t>(row0) * (m + 1);
  for (int i = threadIdx.x; i < rows * (m + 1); i += blockDim.x) {
    const int r = i / (m + 1);
    const int k = i - r * (m + 1);
    const float2* zr = z + r * m;
    float xr, xi;
    if (k == m) {
      xr = zr[0].x - zr[0].y;
      xi = 0.0f;
    } else {
      const float2 zk = zr[k];
      const float2 zn = zr[(m - k) & (m - 1)];
      const float er = 0.5f * (zk.x + zn.x), ei = 0.5f * (zk.y - zn.y);
      const float orr = 0.5f * (zk.y + zn.y), oi = -0.5f * (zk.x - zn.x);
      const float2 w = bf.tw[k];
      xr = er + w.x * orr - w.y * oi;
      xi = ei + w.x * oi + w.y * orr;
    }
    a.out_r[out + i] = xr;
    a.out_i[out + i] = xi;
  }
}

__global__ void __launch_bounds__(kThreads) irfft_stockham_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  const int m = a.n / 2;
  const int row0 = blockIdx.x * a.rows;
  const int rows = min(a.rows, a.batch - row0);
  const Bufs bf = setup(a, smem, m);
  // z[k] = E[k] + i O[k], E = (S[k] + conj S[m-k])/2,
  // O = (S[k] - conj S[m-k])/2 * conj(w^k); Im S[0] and Im S[m] dropped
  const int log2m = log2i(m);
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
    const int r = i >> log2m;
    const int k = i & (m - 1);
    const size_t s = static_cast<size_t>(row0 + r) * (m + 1);
    const float ar = a.in_r[s + k], ai = k == 0 ? 0.0f : a.in_i[s + k];
    const float cr = a.in_r[s + m - k], ci = k == 0 ? 0.0f : -a.in_i[s + m - k];
    const float er = 0.5f * (ar + cr), ei = 0.5f * (ai + ci);
    const float dr = 0.5f * (ar - cr), di = 0.5f * (ai - ci);
    const float2 w = bf.tw[k];  // conj(w^k) = (w.x, -w.y)
    const float orr = dr * w.x + di * w.y, oi = di * w.x - dr * w.y;
    bf.x[i] = make_float2(er - oi, ei + orr);
  }
  __syncthreads();
  const float2* z = stockham(bf.x, bf.y, m, rows, true, bf.tw, log2i(a.n));
  const float inv = 1.0f / static_cast<float>(m);
  float* y = a.out_r + static_cast<size_t>(row0) * a.n;
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
    y[2 * i] = z[i].x * inv;
    y[2 * i + 1] = z[i].y * inv;
  }
}

// W_n^m = exp(-2 pi i m / n) for 0 <= m < n from the n/2-point table
// (W_n^(m + n/2) = -W_n^m), conjugated for the inverse.
__device__ __forceinline__ float2 wpow(const float2* tw, int m, int half, bool inverse) {
  float2 w = m < half ? tw[m] : make_float2(-tw[m - half].x, -tw[m - half].y);
  if (inverse) w.y = -w.y;
  return w;
}

// acc + x w, four FMAs
__device__ __forceinline__ float2 cmac(float2 acc, float2 x, float2 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.x = fmaf(-x.y, w.y, acc.x);
  acc.y = fmaf(x.x, w.y, acc.y);
  acc.y = fmaf(x.y, w.x, acc.y);
  return acc;
}

constexpr int kTile = 4;  // grid rows per thread in fft_fourstep's row DFTs (FOURSTEP_TILE)

__global__ void __launch_bounds__(kThreads) fft_fourstep_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  const int n = a.n, half = n >> 1, log2n = log2i(n);
  const int log2n2 = min(7, log2n), log2n1 = log2n - log2n2;
  const int n1 = 1 << log2n1, n2 = 1 << log2n2;
  const int rows = min(a.rows, a.batch - static_cast<int>(blockIdx.x) * a.rows);
  const bool inverse = a.sign > 0;
  const Bufs bf = setup(a, smem, n);
  load_rows(a, bf.x, n, rows, false);
  __syncthreads();
  // column DFTs and twiddle: y[r][c][b] = W_n^{c b} sum_a x[r][a][b] W_n1^{a c},
  // a thread per (r, b) and group of up to kTile values of c
  const int tc = min(n1, kTile), log2g = log2n1 - log2i(tc);
  for (int t = threadIdx.x; t < (a.rows * n) / tc; t += blockDim.x) {
    const int b = t & (n2 - 1);
    const int c0 = ((t >> log2n2) & ((1 << log2g) - 1)) * tc;
    const int r = t >> (log2n2 + log2g);
    const float2* x = bf.x + (r << log2n) + b;
    float2 acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = make_float2(0.0f, 0.0f);
    for (int k = 0; k < n1; ++k) {
      const float2 v = x[k << log2n2];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j < tc) {
          // W_n1^{k c} = W_n^{(k c mod n1) n2}; the product wraps mod 2^32, n1 divides it
          const unsigned kc = static_cast<unsigned>(k) * static_cast<unsigned>(c0 + j);
          acc[j] = cmac(acc[j], v, wpow(bf.tw, static_cast<int>(kc & (n1 - 1)) << log2n2,
                                        half, inverse));
        }
      }
    }
    float2* y = bf.y + (r << log2n) + b;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < tc) y[(c0 + j) << log2n2] = asp::cmul(acc[j], wpow(bf.tw, (c0 + j) * b, half,
                                                                  inverse));
    }
  }
  __syncthreads();
  // row DFTs: s[m][d] = sum_b y[m][b] W_n2^{b d} over the grid rows m = r n1 + c,
  // a thread per d and kTile consecutive m, stored transposed: x[r][d][c]
  const float2* f2 = reinterpret_cast<const float2*>(a.table);
  for (int t = threadIdx.x; t < (a.rows * n) / kTile; t += blockDim.x) {
    const int d = t & (n2 - 1);
    const int m0 = (t >> log2n2) * kTile;
    const float2* y = bf.y + (m0 << log2n2);
    float2 acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = make_float2(0.0f, 0.0f);
    for (int b = 0; b < n2; ++b) {
      float2 w = __ldg(f2 + (b << log2n2) + d);
      if (inverse) w.y = -w.y;
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] = cmac(acc[j], y[(j << log2n2) + b], w);
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int m = m0 + j;
      bf.x[((m >> log2n1) << log2n) + (d << log2n1) + (m & (n1 - 1))] = acc[j];
    }
  }
  __syncthreads();
  store_rows(a, bf.x, n, rows, false);
}

// Radix-2 decimation in time: the bit reversal in the load, then the
// stages in place; twiddles from the n/2-point table (kStageTable false)
// or from the stacked per-stage table a.table (true).
template <bool kStageTable>
__global__ void __launch_bounds__(kThreads) fft_radix2_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  const int n = a.n, half = n >> 1, log2n = log2i(n);
  const int rows = min(a.rows, a.batch - static_cast<int>(blockIdx.x) * a.rows);
  const bool inverse = a.sign > 0;
  const Bufs bf = setup(a, smem, n);
  load_rows(a, bf.x, n, rows, true);
  __syncthreads();
  const float2* st = reinterpret_cast<const float2*>(a.table);
  for (int s = 0; s < log2n; ++s) {
    const int m = 1 << s;
    for (int t = threadIdx.x; t < rows * half; t += blockDim.x) {
      const int r = t >> (log2n - 1);
      const int k = t & (half - 1);  // the butterfly within the row
      const int p = k & (m - 1);
      float2* x = bf.x + (r << log2n) + ((k >> s) << (s + 1)) + p;
      float2 w;
      if (kStageTable) {
        w = __ldg(st + s * half + k);
      } else {
        w = bf.tw[p << (log2n - 1 - s)];  // exp(-i pi p / m)
        if (inverse) w.y = -w.y;
      }
      const float2 u = x[0];
      const float2 v = asp::cmul(x[m], w);
      x[0] = make_float2(u.x + v.x, u.y + v.y);
      x[m] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
  store_rows(a, bf.x, n, rows, false);
}

// Constant geometry: one stage body, run log2 n times between the
// ping-pong buffers; the bit reversal in the store.
__global__ void __launch_bounds__(kThreads) fft_pease_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  const int n = a.n, half = n >> 1, log2n = log2i(n);
  const int rows = min(a.rows, a.batch - static_cast<int>(blockIdx.x) * a.rows);
  const bool inverse = a.sign > 0;
  const Bufs bf = setup(a, smem, n);
  load_rows(a, bf.x, n, rows, false);
  __syncthreads();
  float2* src = bf.x;
  float2* dst = bf.y;
  for (int s = 0; s < log2n; ++s) {
    for (int t = threadIdx.x; t < rows * half; t += blockDim.x) {
      const int r = t >> (log2n - 1);
      const int k = t & (half - 1);
      const float2* in = src + (r << log2n);
      float2* out = dst + (r << log2n);
      const float2 u = in[k], v = in[k + half];
      float2 w = bf.tw[(k >> s) << s];
      if (inverse) w.y = -w.y;
      out[2 * k] = make_float2(u.x + v.x, u.y + v.y);
      out[2 * k + 1] = asp::cmul(make_float2(u.x - v.x, u.y - v.y), w);
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }
  store_rows(a, src, n, rows, true);
}

int launch(void (*kernel)(asp::FftArgs), const asp::FftArgs* a, int smem_bytes,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a->batch + a->rows - 1) / a->rows;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launches on `stream` (a cudaStream_t) and returns cudaGetLastError()
// after the launch: 0 on success.  Nothing is synchronized or allocated.
int asp_fft_stockham(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(fft_stockham_kernel, a, smem_bytes, device, stream);
}

int asp_rfft_stockham(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(rfft_stockham_kernel, a, smem_bytes, device, stream);
}

int asp_irfft_stockham(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(irfft_stockham_kernel, a, smem_bytes, device, stream);
}

int asp_fft_fourstep(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(fft_fourstep_kernel, a, smem_bytes, device, stream);
}

int asp_fft_radix2_lanes(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(fft_radix2_kernel<false>, a, smem_bytes, device, stream);
}

int asp_fft_radix2_stages(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(fft_radix2_kernel<true>, a, smem_bytes, device, stream);
}

int asp_fft_pease_lanes(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(fft_pease_kernel, a, smem_bytes, device, stream);
}

}  // extern "C"
