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
  const size_t base = static_cast<size_t>(row0) * m;
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x)
    bf.x[i] = make_float2(a.in_r[base + i], a.in_i[base + i]);
  __syncthreads();
  const float2* z = stockham(bf.x, bf.y, m, rows, a.sign > 0, bf.tw, log2i(m));
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
    a.out_r[base + i] = z[i].x;
    a.out_i[base + i] = z[i].y;
  }
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

}  // extern "C"
