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
// natural order with no bit-reversal pass.
//
// fft_stockham_lanes runs the stages in registers (csrc/fft_regs.cuh,
// stockham_pass): a thread holds the 16 points of a row that four
// consecutive stages keep among themselves (the same segment's top bits l
// and low bits p), runs the four stages on them with no barrier, and
// writes them back at stride n/16; n = 1024 takes 4 + 4 + 2 stages and 2
// barriers where a stage each took 10.  The first pass loads from device
// memory and the last stores there, both coalesced; the exchange planes in
// between are XOR-swizzled (pease_swizzle: conflict-free for every warp
// access of these passes); the twiddles come from a per-stage table
// (stockham_stage_table: stage s's 2^s values at 2^s - 1), whose float32
// values are the plain version's, read from device memory through the L1
// cache as neighbouring entries or one broadcast entry.  A CTA takes
// max(1, 4096 / n) rows (RADIX2_POINTS, 16 points a thread); rows too long
// for shared memory (n > 8192) run their passes through a scratch buffer
// in device memory.
//
// rfft_stockham and irfft_stockham run the same passes on the m = n/2
// points z[k] = x[2k] + i x[2k+1] of a real row (kernels/fft_kernel.py
// real_stockham_passes).  rfft's first pass reads z as one float2 a point;
// its last pass runs its groups in pairs whose outputs are each other's
// mirrors, so one thread holds Z[k] and Z[(m - k) mod m] and writes both
// bins X[k] = E[k] + w^k O[k] from registers.  irfft's first pass runs the
// same pairs and untangles as it loads, each bin read once (S[k] and S[m -
// k] from device memory); its last writes z[k] / m as one float2, y[2k]
// and y[2k+1].  A pair holds at most 16 points: the untangle's pass takes
// log2 m mod 4 stages (1 where that is 0, beside a pass of three).  A CTA
// takes max(1, 4096 / m) rows; n = 1024 runs 4 + 4 + 1 stages (rfft) and
// 1 + 4 + 4 (irfft) with 2 barriers each, where the radix-2 loop took a
// barrier a stage and 11 in all, and no shared-memory pass or barrier of
// its own for either untangle.  The m-point per-stage table and the
// n/2-point untangle table (w^k = exp(-2 pi i k / n), float64 on the host)
// are read from device memory through the L1 cache; rows past 8192 complex
// points run their passes through a scratch buffer, as the complex kernel
// does.  The TPU kernels' transposes to a batch-in-lanes layout and their
// two-pass reversal trick (a Mosaic limitation) do not carry over.
//
// What bounds it on an H100: at 4096 rows x 1024 points a complex
// transform moves 67 MB (20 us at 3.35 TB/s) and does 5 n log2 n flops a
// row (0.2 GFLOP, 3 us at 67 TFLOP/s), so device memory bounds it, and
// every byte is read and written once.  fft_stockham_lanes adds the
// shared-memory exchange (2 x 8 bytes a point a pass) and its barriers;
// a real transform moves half the bytes (n floats in, n + 2 out a row) and
// pays the same exchange on half the points; its untangle costs registers
// (two groups a thread in one pass) and, for irfft, the mirror bins' reads
// through the L1 cache.  ptxas (sm_90a): rfft 64 to 76 registers past 16
// points (a 4-byte spill at RS = 4), 30 to 54 in the one-pass
// instantiations (m <= 16); irfft at most 80 past 16 points (three CTAs an
// SM; a 28-byte spill at RS = 8), 31 to 168 in the one-pass ones.
//
// The other complex transforms of the package's impl registry, same
// planar contract, rows staged in shared memory (or device-memory buffers
// for rows too long for it), host float64 tables:
//
// - fft_fourstep (replaces kernels/fft_kernel.py fft_fourstep): the
//   four-step factorization n = n1 n2, n2 = min(128, n), of the row viewed
//   as the grid X[a][b] = x[a n2 + b]: n1-point DFTs down the columns,
//   the twiddle W_n^{c b}, n2-point DFTs along the rows, each a dense
//   product against its table, the output transposed, T[d][c] = S[n1 d +
//   c].  The TPU kernel runs the products on its matrix unit as 3-pass
//   bf16 splits; here they run on the tensor cores (mma.sync m16n8k8
//   TF32) as 3-pass TF32 splits: each operand is big + small, both TF32
//   (cvt.rna), and each real product is big big + big small + small big,
//   accumulated in float32, so the products hold float32 accuracy; no
//   product is a single TF32 pass.  The tables are split on the host from
//   float64 (fourstep_tc_tables: the n2 and n1 distinct values W_N^j, not
//   the dense N x N tables, since W_N^{k n} = W_N^{k n mod N}); a CTA keeps
//   them in shared memory in eight copies side by side, so a fragment's
//   gather W_N^{(k n) mod N} is free of bank conflicts (lane l reads copy
//   l mod 8).  The data is split in registers as fragments load.
//   A CTA takes max(64, n1) grid rows (64 / n1 rows; M a multiple of 32)
//   and stages them in Z in shared memory by 16-byte cp.async copies (row
//   stride n2 + 8 floats, so the fragment loads are conflict-free).
//   Column side, in place in Z: for n1 = 8 to 32 (n = 1024 to 4096) per row
//   (n2 x n1)(n1 x n1) on the tensor cores, a warp owning all n1 outputs of
//   its grid columns, the epilogue multiplying by W_n^{c b}; for n1 < 8 in
//   float32 FMAs, a thread per grid column.  From n1 = 64 the column side
//   reads its A fragments from device memory, and above n = 16384 (n1 >
//   128) Z lives in the scratch buffer in device memory and the column
//   table is read from device memory.  Row side: (gm x n2)(n2 x n2) on the
//   tensor cores, a warp item 32 grid rows x 32 columns, the store
//   transposed.  n = 4 pads its 4 x 4 table to k = 8 with zeros.  Each
//   column-side path is its own kernel instantiation, so each holds only
//   its own registers.  What bounds it: the tensor work, 24 n (n2 + n1) a
//   row for n1 >= 8 (at 4096 x 1024 13.7 GFLOP, 28 us at the 495 TFLOP/s
//   TF32 peak, over 20 us of bytes), and in practice the instructions
//   around each mma.sync (loading and splitting A, gathering B), which
//   hold it near 0.1 ms there on an H100 SXM at 700 W (PERF.md).
//   ptxas (sm_90a): 128 registers in every instantiation (the launch
//   bounds' cap for two CTAs of 256 threads an SM); spill stores 4 B in
//   the in-place one (n = 1024 to 4096), 48 B in the n1 >= 64 one, none
//   in the others.
// - fft_radix2_lanes (replaces fft_radix2_lanes): the classic C loop,
//   the bit-reversal permutation and then the log2 n decimation-in-time
//   stages, twiddle exp(sign i pi p / m) at half-size m, the same float32
//   values as fft_radix2_stages' table; the TPU kernel computes them with
//   f32 cos/sin.  The stages run in registers (csrc/fft_regs.cuh): a
//   thread holds 16 points and runs up to 4 stages on them, so n = 1024
//   takes 3 passes and 2 barriers where a stage each took 10; the bit
//   reversal is the first pass's choice of points (coalesced loads, each
//   thread's 16 points n/16 apart); the exchange planes between passes are
//   XOR-swizzled (conflict-free); the twiddles come from a per-stage table
//   (stage s at offset 2^s - 1), read as neighbouring entries or one
//   broadcast entry.  What bounds it: device memory (every byte moved
//   once) and the shared-memory exchange, 2 x 8 bytes a point a pass.
//   ptxas (sm_90a): 58 registers at R = 16 (31 to 40 for n < 16), no
//   spills.
// - fft_radix2_stages (replaces fft_radix2_stages, which the TPU ran only
//   in interpret mode): fft_radix2_lanes' transform, the same stages,
//   pairs and float32 twiddle values, with its twiddles handed over as
//   the stacked (log2 n, n/2) per-stage table of the sign asked for.  It
//   is fft_radix2_lanes' kernel instantiated for that table (kStacked):
//   the first pass (and every pass where the rows live in device memory)
//   reads row s, entry s n/2 + p; a CTA stages only the n - 1 distinct
//   entries (row s, p < 2^s) into shared memory in the per-stage layout,
//   shifted by one entry (stage s at 2^s) so that each cp.async is 16
//   aligned bytes of one row, as many copies as fft_radix2_lanes makes.
//   Its results equal fft_radix2_lanes' bit for bit.  ptxas (sm_90a): 60
//   registers at R = 16 (27 to 40 for n < 16), no spills.
// - fft_pease_lanes (replaces fft_pease_lanes): the log2 n
//   constant-geometry stages u = A[k], v = A[k + n/2] -> B[2k] = u + v,
//   B[2k+1] = (u - v) w_s[k], w_s[k] = exp(sign 2 pi i ((k >> s) << s) /
//   n), in registers (csrc/fft_regs.cuh): a thread holds the 16 points g +
//   t n/16 of its group g, whose indices differ in their top four bits, and
//   runs four stages on them with no exchange, after which they are the 16
//   consecutive points g 16 + j.  Every pass is that one body, looped
//   (reads at stride n/16, consecutive writes; a shorter last pass where
//   log2 n is not a multiple of 4), so n = 1024 takes 4 + 4 + 2 stages and
//   2 barriers where a stage each took 10.  The bit reversal of the result
//   is the last pass's choice of points (thread q takes g = brev(q), so
//   its slot j lands at natural index brev(j) n/16 + q: coalesced stores);
//   the TPU package gathers it in XLA afterwards.  The exchange between
//   passes goes through two buffers of re/im planes, XOR-swizzled
//   (conflict-free), in shared memory up to 8192 points, in the scratch
//   buffer above; the twiddles come from a per-stage table (stage s's
//   n/2^(s+1) values w_s[m 2^s] at n - n/2^s), read by the first pass from
//   device memory as neighbouring entries while cp.async copies the later
//   stages' n/16 entries to shared memory, where each is one broadcast.
//   What bounds it: as fft_radix2_lanes.  ptxas (sm_90a): 63 or 64
//   registers with a shorter last pass, 74 without one (n = 256, 4096,
//   65536, ...), 25 to 40 for n < 16; no spills.

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace asp {

// The kernels' arguments; kernels/fft_kernel.py (FftArgs) mirrors it.
struct FftArgs {
  const float* in_r;   // complex: re plane (B, n); rfft: x (B, n); irfft: re (B, n/2+1)
  const float* in_i;   // complex: im plane; rfft: unused; irfft: im (B, n/2+1)
  float* out_r;        // complex: re (B, n); rfft: re (B, n/2+1); irfft: y (B, n)
  float* out_i;        // complex: im (B, n); rfft: im (B, n/2+1); irfft: unused
  const float* tw;     // n/2 twiddles exp(-2 pi i k / n) as (re, im) pairs
  float* scratch;      // a kernel's buffers in device memory for long rows, or null
  const float* table;  // fft_fourstep: the split tables (fourstep_tc_tables);
                       // fft_radix2_stages: the (log2 n, n/2) stage table of `sign`;
                       // fft_radix2_lanes, fft_pease_lanes, fft_stockham_lanes: their
                       // per-stage tables of `sign`; rfft_stockham, irfft_stockham:
                       // the n/2-point per-stage table (forward, inverse)
  int batch;           // B rows
  int n;               // the row length the caller sees
  int sign;            // complex transform: -1 forward, +1 inverse
  int rows;            // rows per CTA
};

}  // namespace asp

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int log2i(int m) { return __ffs(m) - 1; }

// W_n^m = exp(-2 pi i m / n) for 0 <= m < n from the n/2-point table
// (W_n^(m + n/2) = -W_n^m), conjugated for the inverse.
__device__ __forceinline__ float2 wpow(const float2* tw, int m, int half, bool inverse) {
  float2 w = m < half ? tw[m] : make_float2(-tw[m - half].x, -tw[m - half].y);
  if (inverse) w.y = -w.y;
  return w;
}

// ---------------------------------------------------------------------------
// fft_fourstep: the DFT products on the tensor cores, 3xTF32
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, nearest, ties away), as a float's bits
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32; the remainder x - big is exact in float32
__device__ __forceinline__ void tf32_split(float x, unsigned& big, unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile: a row-major 16 x 8, b column-major 8 x 8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A tile's operand split into TF32 halves: the real and imaginary planes
struct SplitA {
  unsigned rb[4], rs[4], ib[4], is[4];
};

// B fragment (two k rows of one n column) of a complex table, split
struct SplitB {
  unsigned rb[2], rs[2], ib[2], is[2];
};

__device__ __forceinline__ void split_a(SplitA& s, int e, float re, float im) {
  tf32_split(re, s.rb[e], s.rs[e]);
  tf32_split(im, s.ib[e], s.is[e]);
}

// (sr, si) += (ar + i ai)(br + i bi) on MT m tiles against one B fragment:
// four real products, each in three TF32 passes, big x small + small x big
// + big x big, accumulated in float32.  No pass is a single-TF32 product:
// small x small (below 2^-22 relative) is the only term dropped.  Issued
// pass by pass (the small cross terms of every tile, then big x big), so
// that consecutive tensor instructions feed different accumulators.
template <int MT, int NT>
__device__ __forceinline__ void cmma3_tiles(float (&sr)[MT][NT][4], float (&si)[MT][NT][4],
                                            int nt, const SplitA (&a)[MT], const SplitB& b) {
  const unsigned nb[2] = {b.ib[0] ^ 0x80000000u, b.ib[1] ^ 0x80000000u};
  const unsigned ns[2] = {b.is[0] ^ 0x80000000u, b.is[1] ^ 0x80000000u};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mma_tf32(sr[mt][nt], a[mt].rs, b.rb[0], b.rb[1]);
    mma_tf32(si[mt][nt], a[mt].rs, b.ib[0], b.ib[1]);
    mma_tf32(sr[mt][nt], a[mt].is, nb[0], nb[1]);
    mma_tf32(si[mt][nt], a[mt].is, b.rb[0], b.rb[1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mma_tf32(sr[mt][nt], a[mt].rb, b.rs[0], b.rs[1]);
    mma_tf32(si[mt][nt], a[mt].rb, b.is[0], b.is[1]);
    mma_tf32(sr[mt][nt], a[mt].ib, ns[0], ns[1]);
    mma_tf32(si[mt][nt], a[mt].ib, b.rs[0], b.rs[1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mma_tf32(sr[mt][nt], a[mt].rb, b.rb[0], b.rb[1]);
    mma_tf32(si[mt][nt], a[mt].rb, b.ib[0], b.ib[1]);
    mma_tf32(sr[mt][nt], a[mt].ib, nb[0], nb[1]);
    mma_tf32(si[mt][nt], a[mt].ib, b.rb[0], b.rb[1]);
  }
}

// Entry e of a split DFT table, {re big, re small, im big, im small}, from
// shared memory where it is kept in eight copies side by side (copy `lane &
// 7` of entry e at float4 8 e + (lane & 7): the eight lanes of a quarter
// warp then read eight different bank groups whatever their entries), or
// from the compact table in device memory (copies = 1), conjugated there
// when `conj` (the shared copies are conjugated as they are made; a sign
// flip is exact on both halves).
__device__ __forceinline__ float4 table_entry(const float4* t, int e, int copies, bool conj) {
  if (copies == 8) return t[e * 8 + (threadIdx.x & 7)];
  float4 v = __ldg(t + e);
  if (conj) {
    v.z = -v.z;
    v.w = -v.w;
  }
  return v;
}

// The B fragment W_N^{k n} of column n (N a power of two) and the two rows
// k of this lane's slots t and t + 4: k0 + t and k0 + t + 4, or with
// kPaired k0 + 2 t and k0 + 2 t + 1 (the row side's order, whose A values
// of one lane then lie side by side); with kPad, zero outside k, n < N
// (n = 4 pads its 4 x 4 table to 8 x 8).
template <bool kPaired = false, bool kPad = false>
__device__ __forceinline__ SplitB dft_fragment(const float4* t, int copies, int N, int k0,
                                               int col, bool conj) {
  const int tq = threadIdx.x & 3;
  SplitB b;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = kPaired ? k0 + 2 * tq + h : k0 + tq + 4 * h;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!kPad || (k < N && col < N)) v = table_entry(t, (k * col) & (N - 1), copies, conj);
    b.rb[h] = __float_as_uint(v.x);
    b.rs[h] = __float_as_uint(v.y);
    b.ib[h] = __float_as_uint(v.z);
    b.is[h] = __float_as_uint(v.w);
  }
  return b;
}

constexpr int kFourstepGrid = 64;  // grid rows a CTA takes at least (FOURSTEP_GRID_ROWS)
constexpr int kZPad = 8;           // Z's row stride is n2 + 8 floats: 8 mod 32 words
constexpr int kFourstepThreads = 256;
constexpr int kRowMTiles = 2;      // a row-side warp item: 2 m tiles (32 grid rows)
constexpr int kRowNTiles = 4;      // x up to 4 n tiles (32 output columns)

// fft_fourstep's shared-memory layout (fourstep_geometry in
// kernels/fft_kernel.py mirrors it): the row table in eight copies, the
// column table in eight copies (8 <= n1 <= 128), the n/2 twiddles (n <=
// 8192), then the planes of Z (n1 <= 128; above, Z lives in the scratch
// buffer in device memory).
struct FourstepGeo {
  int n1, n2, n2p, log2n1, gm, zs;
  bool z_shared, t1_shared, tw_shared;
};

__device__ FourstepGeo fourstep_geo(int n) {
  FourstepGeo g;
  const int log2n = log2i(n);
  const int log2n2 = min(7, log2n);
  g.n2 = 1 << log2n2;
  g.log2n1 = log2n - log2n2;
  g.n1 = 1 << g.log2n1;
  g.n2p = max(8, g.n2);
  g.gm = max(kFourstepGrid, g.n1);
  g.zs = g.n2p + kZPad;
  g.z_shared = g.n1 <= 128;
  g.t1_shared = g.n1 >= 8 && g.n1 <= 128;
  g.tw_shared = n <= 8192;
  return g;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem_dst))),
               "l"(gmem_src)
               : "memory");
}

// Where the column side reads X[r][a][b]: the CTA's input rows in device
// memory, or Z itself after the load (rows past the batch zero there).
struct ColSource {
  const float* re;
  const float* im;
  int row_stride, a_stride;
  bool global;
};

// The column DFTs and the twiddle of the CTA's rows on the tensor cores
// (n1 >= 8): per row, Y^T = X^T F1 as (n2 x n1)(n1 x n1), M = the n2 grid
// columns b, K = a, N = c; the A fragments split in registers as they
// load; the epilogue multiplies by W_n^{c b} and writes Z[r n1 + c][b].
// In place (n1 <= 32) a warp reads all its X before it writes, and no
// other warp touches those grid columns of the row.
__device__ void fourstep_columns_mma(const FourstepGeo& g, const ColSource& x,
                                     const float4* t1, int t1_copies, const float2* tw,
                                     float* zr, float* zi, int rows, int n, bool inverse) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int half = n >> 1;
  const int nw = min(4, g.n1 >> 3);           // n tiles per item
  const int ngroups = (g.n1 >> 3) / nw;       // groups of nw tiles along c
  const int items = (g.gm >> g.log2n1) * 4 * ngroups;  // rows x 4 pairs of b tiles x c groups
  for (int it = warp; it < items; it += kFourstepThreads / 32) {
    const int ng = it % ngroups, mg = (it / ngroups) & 3, r = it / (ngroups * 4);
    const int b0 = mg * 32, c0 = ng * nw * 8;
    const bool valid = !x.global || r < rows;
    const float* xr = x.re + static_cast<size_t>(r) * x.row_stride;
    const float* xi = x.im + static_cast<size_t>(r) * x.row_stride;
    float sr[2][4][4] = {}, si[2][4][4] = {};
    for (int k0 = 0; k0 < g.n1; k0 += 8) {
      SplitA as[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (k0 + tq + 4 * (e >> 1)) * x.a_stride + b0 + mt * 16 + gq + 8 * (e & 1);
          float re = 0.0f, im = 0.0f;
          if (valid) {
            re = xr[i];
            im = xi[i];
          }
          split_a(as[mt], e, re, im);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < nw) {
          const SplitB bf = dft_fragment(t1, t1_copies, g.n1, k0, c0 + nt * 8 + gq, inverse);
          cmma3_tiles<2>(sr, si, nt, as, bf);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < nw) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = b0 + mt * 16 + gq + 8 * (e >> 1);
            const int c = c0 + nt * 8 + 2 * tq + (e & 1);
            const float2 z = asp::cmul(make_float2(sr[mt][nt][e], si[mt][nt][e]),
                                       wpow(tw, c * b, half, inverse));
            const int zi_ = ((r << g.log2n1) + c) * g.zs + b;
            zr[zi_] = z.x;
            zi[zi_] = z.y;
          }
        }
      }
    }
  }
}

// The column DFTs and twiddle in float32 FMAs (n1 = N1 <= 4, n <= 512), in
// place in Z: a thread per (row, grid column b) reads its n1 values, then
// writes its n1 outputs.
template <int N1>
__device__ void fourstep_columns_fma(const FourstepGeo& g, const float2* tw, float* zr,
                                     float* zi, int rows_cta, int n, bool inverse) {
  const int half = n >> 1, log2n2 = log2i(g.n2);
  for (int t = threadIdx.x; t < rows_cta * g.n2; t += blockDim.x) {
    const int r = t >> log2n2, b = t & (g.n2 - 1);
    float2 x[N1];
#pragma unroll
    for (int k = 0; k < N1; ++k) {
      const int i = (r * N1 + k) * g.zs + b;
      x[k] = make_float2(zr[i], zi[i]);
    }
#pragma unroll
    for (int c = 0; c < N1; ++c) {
      float2 acc = x[0];
#pragma unroll
      for (int k = 1; k < N1; ++k) {
        // W_n1^{k c} = W_n^{(k c mod n1) n2}
        const float2 w = wpow(tw, ((k * c) & (N1 - 1)) * g.n2, half, inverse);
        acc.x = fmaf(x[k].x, w.x, fmaf(-x[k].y, w.y, acc.x));
        acc.y = fmaf(x[k].x, w.y, fmaf(x[k].y, w.x, acc.y));
      }
      const float2 z = asp::cmul(acc, wpow(tw, c * b, half, inverse));
      const int i = (r * N1 + c) * g.zs + b;
      zr[i] = z.x;
      zi[i] = z.y;
    }
  }
}

// The row DFTs on the tensor cores: S = Z F2 over the CTA's gm grid rows,
// M = grid rows, K = N = n2 (8 for n = 4, its table zero-padded); a warp
// item is 2 m tiles x up to 4 n tiles, the A fragments read from Z in
// pairs (row stride 8 mod 32: conflict-free) and split in registers, the B
// fragments from the eight-copy table.  The store is the transpose T[d][c] = S[c][d].
template <bool kPad>
__device__ void fourstep_rows_mma(const asp::FftArgs& a, const FourstepGeo& g,
                                  const float4* t2, const float* zr, const float* zi,
                                  int rows) {
  constexpr int MT = kRowMTiles, NT = kRowNTiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n = a.n;
  const int nw = min(NT, g.n2p >> 3);
  const int ngroups = (g.n2p >> 3) / nw;
  const int items = (g.gm / (16 * MT)) * ngroups;
  const size_t base = static_cast<size_t>(blockIdx.x) * a.rows * n;
  for (int it = warp; it < items; it += kFourstepThreads / 32) {
    const int ng = it % ngroups, m0 = (it / ngroups) * 16 * MT, d0 = ng * nw * 8;
    float sr[MT][NT][4] = {}, si[MT][NT][4] = {};
    for (int k0 = 0; k0 < g.n2p; k0 += 8) {
      SplitA as[MT];
      // slots t and t + 4 hold K indices k0 + 2 t and k0 + 2 t + 1 (the B
      // fragment follows), so a lane reads each pair of values at once
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = (m0 + mt * 16 + gq + 8 * e) * g.zs + k0 + 2 * tq;
          const float2 re = *reinterpret_cast<const float2*>(zr + i);
          const float2 im = *reinterpret_cast<const float2*>(zi + i);
          split_a(as[mt], e, re.x, im.x);
          split_a(as[mt], e + 2, re.y, im.y);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nw) {
          const SplitB bf = dft_fragment<true, kPad>(t2, 8, g.n2, k0, d0 + nt * 8 + gq, false);
          cmma3_tiles<MT>(sr, si, nt, as, bf);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nw) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + mt * 16 + gq + 8 * (e >> 1);
            const int d = d0 + nt * 8 + 2 * tq + (e & 1);
            const int r = m >> g.log2n1, c = m & (g.n1 - 1);
            if (r < rows && d < g.n2) {
              const size_t o = base + static_cast<size_t>(r) * n + (d << g.log2n1) + c;
              a.out_r[o] = sr[mt][nt][e];
              a.out_i[o] = si[mt][nt][e];
            }
          }
        }
      }
    }
  }
}

// A table's entries into shared memory as eight copies each, conjugated for
// the inverse.
__device__ void copy_table8(float4* dst, const float4* src, int entries, bool inverse) {
  for (int i = threadIdx.x; i < entries * 8; i += blockDim.x) {
    float4 v = __ldg(src + (i >> 3));
    if (inverse) {
      v.z = -v.z;
      v.w = -v.w;
    }
    dst[i] = v;
  }
}

// How fft_fourstep's column side runs, by n: one kernel each, so that each
// holds only its own path's registers.
enum FourstepCols {
  kColsPad,     // n = 4: no column DFT (n1 = 1), the 4 x 4 row table padded to 8 x 8
  kColsFma1,    // n <= 128 (n1 = 1): the rows as they are
  kColsFma2,    // n = 256 (n1 = 2): float32 FMAs in Z
  kColsFma4,    // n = 512 (n1 = 4): float32 FMAs in Z
  kColsInPlace, // 8 <= n1 <= 32: tensor cores, in place in Z
  kColsGlobal,  // n1 >= 64: tensor cores, X read from device memory
};

template <int kCols>
__global__ void __launch_bounds__(kFourstepThreads, 512 / kFourstepThreads)
    fft_fourstep_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  const FourstepGeo g = fourstep_geo(a.n);
  const int rows = min(a.rows, a.batch - static_cast<int>(blockIdx.x) * a.rows);
  const bool inverse = a.sign > 0;
  const size_t base = static_cast<size_t>(blockIdx.x) * a.rows * a.n;
  const float4* t2_g = reinterpret_cast<const float4*>(a.table);
  const float4* t1_g = t2_g + g.n2;
  // carve shared memory
  float4* t2 = smem;
  float4* p = t2 + g.n2p * 8;
  float4* t1s = p;
  const float4* t1 = g.t1_shared ? t1s : t1_g;
  if (g.t1_shared) p += g.n1 * 8;
  const float2* tw = reinterpret_cast<const float2*>(a.tw);
  float2* tws = reinterpret_cast<float2*>(p);
  if (g.tw_shared) p += a.n / 4;
  float* zr = g.z_shared ? reinterpret_cast<float*>(p)
                         : a.scratch + static_cast<size_t>(blockIdx.x) * 2 * g.gm * g.zs;
  float* zi = zr + g.gm * g.zs;
  constexpr bool kInPlace = kCols != kColsGlobal;
  if (kInPlace) {
    // the CTA's rows into Z by asynchronous 16-byte copies (grid row a of row
    // r at Z row r n1 + a); rows past the batch and n = 4's pad columns zero
    const int chunks = g.n2 >> 2, log2c = log2i(chunks);
    for (int i = threadIdx.x; i < (rows * g.n1) << log2c; i += blockDim.x) {
      const int q = i >> log2c, o = (i & (chunks - 1)) << 2;
      cp_async16(zr + q * g.zs + o, a.in_r + base + (static_cast<size_t>(q) << log2i(g.n2)) + o);
      cp_async16(zi + q * g.zs + o, a.in_i + base + (static_cast<size_t>(q) << log2i(g.n2)) + o);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (rows < a.rows || g.n2 < g.n2p) {
      const int log2n2p = log2i(g.n2p);
      for (int i = threadIdx.x; i < g.gm * g.n2p; i += blockDim.x) {
        const int q = i >> log2n2p, o = i & (g.n2p - 1);
        if (q >= rows * g.n1 || o >= g.n2) {
          zr[q * g.zs + o] = 0.0f;
          zi[q * g.zs + o] = 0.0f;
        }
      }
    }
  }
  copy_table8(t2, t2_g, g.n2, inverse);
  if (g.t1_shared) copy_table8(t1s, t1_g, g.n1, inverse);
  if (g.tw_shared) {
    for (int i = threadIdx.x; i < a.n / 2; i += blockDim.x) tws[i] = __ldg(tw + i);
    tw = tws;
  }
  if (kInPlace) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();  // the tables, the twiddles and the rows
  if (kCols == kColsFma2) {
    fourstep_columns_fma<2>(g, tw, zr, zi, a.rows, a.n, inverse);
  } else if (kCols == kColsFma4) {
    fourstep_columns_fma<4>(g, tw, zr, zi, a.rows, a.n, inverse);
  } else if (kCols == kColsInPlace) {
    fourstep_columns_mma(g, {zr, zi, g.n1 * g.zs, g.zs, false}, t1, 8, tw, zr, zi, rows, a.n,
                         inverse);
  } else if (kCols == kColsGlobal) {
    fourstep_columns_mma(g, {a.in_r + base, a.in_i + base, a.n, g.n2, true}, t1,
                         g.t1_shared ? 8 : 1, tw, zr, zi, rows, a.n, inverse);
  }
  __syncthreads();  // Z
  fourstep_rows_mma<kCols == kColsPad>(a, g, t2, zr, zi, rows);
}

// ---------------------------------------------------------------------------
// fft_radix2_lanes and fft_radix2_stages: the stages in registers
// (csrc/fft_regs.cuh)
// ---------------------------------------------------------------------------

constexpr int kRadix2Points = 4096;  // points a CTA takes at least (RADIX2_POINTS)

// q < 2^bits bit-reversed
__device__ __forceinline__ int brev_low(int q, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(q)) >> (32 - bits));
}

// Each thread holds R points of a row (R = 16, or n below 16).  The first
// pass takes the R points x[v + k n/R] of its group v (coalesced loads:
// neighbouring threads read neighbouring points), which after the bit
// reversal are the R consecutive indices brev(v) R + brev_r(k): the bit
// reversal is only the choice of points and slots.  Each pass runs up to
// r = log2 R stages in registers; the points go through the exchange
// planes (shared memory, or this CTA's slice of the scratch buffer in
// device memory above 8192 points) between passes, one barrier each; the
// last pass stores natural order, coalesced.  The per-stage table (n
// entries, stage s at offset 2^s - 1) is copied to shared memory with
// cp.async during the first pass, which reads its 15 entries from device
// memory.  kStacked (fft_radix2_stages): a.table is the stacked (log2 n,
// n/2) table, read as row s where the passes read device memory; only its
// n - 1 distinct entries (row s, p < 2^s) go to shared memory, into the
// per-stage layout one entry further on, so the two kernels run the same
// arithmetic on the same float32 values.
template <int R, bool kStacked>
__global__ void __launch_bounds__(kThreads) fft_radix2_lanes_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  constexpr int r = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const int n = a.n, log2n = log2i(n);
  const int log2g = log2n - r;  // log2 of the groups of a row
  const int row0 = blockIdx.x * a.rows;
  const int groups = min(a.rows, a.batch - row0) << log2g;
  const float2* tw_g = reinterpret_cast<const float2*>(a.table);
  const float2* tw = tw_g;
  float* er;
  if (a.scratch != nullptr) {
    er = a.scratch + static_cast<size_t>(blockIdx.x) * a.rows * 2 * n;
  } else {
    float2* tw_s = reinterpret_cast<float2*>(smem);
    if (log2n > r) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        // kStacked: entries 2i, 2i + 1 of the per-stage layout shifted by one
        // (stage s at 2^s) are row s's p = 2i - 2^s and p + 1 (for i = 0
        // row 0's first two, both 1, so entry 1 is stage 0's)
        const int s = kStacked && i > 0 ? 32 - __clz(i) : 0;
        const int src = kStacked ? s * (n / 2) + 2 * i - (i > 0 ? 1 << s : 0) : 2 * i;
        cp_async16(tw_s + 2 * i, tw_g + src);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      tw = kStacked ? tw_s + 1 : tw_s;
    }
    er = reinterpret_cast<float*>(tw_s + n);
  }
  float* ei = er + a.rows * n;
  const size_t base = static_cast<size_t>(row0) * n;
  for (int s0 = 0; s0 < log2n;) {
    const int s1 = min(s0 + r, log2n), f = s1 - r;
    const bool first = s0 == 0, last = s1 == log2n;
    for (int v = threadIdx.x; v < groups; v += blockDim.x) {
      const int row = v >> log2g, q = v & ((1 << log2g) - 1);
      const size_t rb = base + (static_cast<size_t>(row) << log2n);
      float* xr = er + (row << log2n);
      float* xi = ei + (row << log2n);
      float2 x[R];
      int g = q;
      if (first) {
        g = brev_low(q, log2g);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const size_t i = rb + q + (static_cast<size_t>(k) << log2g);
          x[asp::brev_bits(k, r)] = make_float2(a.in_r[i], a.in_i[i]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int i = asp::dit_swizzle(asp::dit_index(g, j, f, r));
          x[j] = make_float2(xr[i], xi[i]);
        }
      }
      if (kStacked && (first || a.scratch != nullptr)) {
        asp::dit_pass<R, true>(x, tw_g, s0, s1, f, g & ((1 << f) - 1), n / 2);
      } else {
        asp::dit_pass<R>(x, first ? tw_g : tw, s0, s1, f, g & ((1 << f) - 1));
      }
      if (last) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const size_t i = rb + asp::dit_index(g, j, f, r);
          a.out_r[i] = x[j].x;
          a.out_i[i] = x[j].y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int i = asp::dit_swizzle(asp::dit_index(g, j, f, r));
          xr[i] = x[j].x;
          xi[i] = x[j].y;
        }
      }
    }
    if (last) break;
    if (first && a.scratch == nullptr) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    s0 = s1;
  }
}

// ---------------------------------------------------------------------------
// fft_pease_lanes: constant-geometry passes in registers (csrc/fft_regs.cuh)
// ---------------------------------------------------------------------------

// One Pease pass of RP = 2^rp points a group from stage s0 over this CTA's
// rows: group v of the CTA is row v >> lg, q = v mod 2^lg (lg = log2 n -
// rp), and takes g = q, or g = brev(q) in the last pass.  It reads slot t
// from index g + t n/RP (device memory in the first pass, else the exchange
// planes sr, si), runs rp stages in registers, and writes slot j to index
// g RP + j of the planes dr, di, or in the last pass to natural index
// brev_rp(j) n/RP + q of the output: coalesced stores, the bit reversal
// being the last pass's choice of points.  Exchange indices are
// CTA-local (row n + index) and swizzled.
template <int RP>
__device__ __forceinline__ void pease_groups(const asp::FftArgs& a, int rows, int s0,
                                             const float* sr, const float* si, float* dr,
                                             float* di, const float2* tw, int off) {
  constexpr int rp = RP == 2 ? 1 : RP == 4 ? 2 : RP == 8 ? 3 : 4;
  const int n = a.n, log2n = log2i(n);
  const int lg = log2n - rp;
  const bool first = s0 == 0, last = s0 + rp == log2n;
  const size_t base = static_cast<size_t>(blockIdx.x) * a.rows * n;
  // the swizzled offsets of slot t's reads, bit by bit: swizzle(t << lg)
  int tsw[rp];
#pragma unroll
  for (int k = 0; k < rp; ++k) tsw[k] = asp::pease_swizzle(1 << (lg + k));
  for (int v = threadIdx.x; v < rows << lg; v += blockDim.x) {
    const int row = v >> lg, q = v & ((1 << lg) - 1);
    const int g = last ? brev_low(q, lg) : q;
    float2 x[RP];
    if (first) {
      const size_t i0 = base + (static_cast<size_t>(row) << log2n) + g;
#pragma unroll
      for (int t = 0; t < RP; ++t) {
        const size_t i = i0 + (static_cast<size_t>(t) << lg);
        x[t] = make_float2(__ldg(a.in_r + i), __ldg(a.in_i + i));
      }
    } else {
      const int i0 = asp::pease_swizzle((row << log2n) | g);
#pragma unroll
      for (int t = 0; t < RP; ++t) {
        int i = i0;
#pragma unroll
        for (int k = 0; k < rp; ++k) {
          if (t & (1 << k)) i ^= tsw[k];
        }
        x[t] = make_float2(sr[i], si[i]);
      }
    }
    asp::pease_pass<RP>(x, tw, s0, log2n, g, off);
    if (last) {
      const size_t o = base + (static_cast<size_t>(row) << log2n) + q;
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const size_t i = o + (static_cast<size_t>(asp::brev_bits(j, rp)) << lg);
        a.out_r[i] = x[j].x;
        a.out_i[i] = x[j].y;
      }
    } else {
      const int i0 = asp::pease_swizzle((row << log2n) | (g << rp));
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        dr[i0 ^ j] = x[j].x;
        di[i0 ^ j] = x[j].y;
      }
    }
  }
}

// Full passes of R = 16 points a group (R = n below 16), then a shorter
// last pass of RS points where log2 n is not a multiple of 4: n = 1024 runs
// 4 + 4 + 2 stages with 2 barriers.  The exchange goes through two buffers
// of re/im planes, a pass reading one and writing the other (one suffices
// for two passes): in shared memory, or in this CTA's slice of the scratch
// buffer in device memory where they do not fit.  a.table is the per-stage
// table (pease_stage_table): the first pass reads its stages 0..3 from
// device memory (neighbouring entries for neighbouring threads) while
// cp.async copies the n/16 entries of the later stages to shared memory.
template <int R, int RS>
__global__ void __launch_bounds__(kThreads) fft_pease_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  constexpr int r = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const int n = a.n, log2n = log2i(n);
  const int rows = min(a.rows, a.batch - static_cast<int>(blockIdx.x) * a.rows);
  const float2* tw_g = reinterpret_cast<const float2*>(a.table);
  const float2* tw = tw_g;  // the later passes' table, from entry `off` on
  int off = 0;
  float* buf;
  if (a.scratch != nullptr) {
    buf = a.scratch + static_cast<size_t>(blockIdx.x) * a.rows * 4 * n;
  } else {
    float2* tw_s = reinterpret_cast<float2*>(smem);
    const int tail = log2n > r ? n >> r : 0;
    for (int i = threadIdx.x; i < tail / 2; i += blockDim.x)
      cp_async16(tw_s + 2 * i, tw_g + (n - tail) + 2 * i);
    asm volatile("cp.async.commit_group;" ::: "memory");
    tw = tw_s;
    off = n - tail;
    buf = reinterpret_cast<float*>(tw_s + tail);
  }
  const int plane = a.rows * n;
  for (int s0 = 0, p = 0; s0 < log2n; s0 += r, ++p) {
    // pass p reads buffer (p - 1) mod 2 and writes buffer p mod 2
    const float* src = buf + ((p + 1) & 1) * 2 * plane;
    float* dst = buf + (p & 1) * 2 * plane;
    if (s0 + r >= log2n) {
      pease_groups<RS>(a, rows, s0, src, src + plane, nullptr, nullptr, s0 == 0 ? tw_g : tw,
                       s0 == 0 ? 0 : off);
      break;
    }
    pease_groups<R>(a, rows, s0, src, src + plane, dst, dst + plane, s0 == 0 ? tw_g : tw,
                    s0 == 0 ? 0 : off);
    if (s0 == 0 && a.scratch == nullptr) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// fft_stockham_lanes: Stockham passes in registers (csrc/fft_regs.cuh)
// ---------------------------------------------------------------------------

// Full passes of R = 16 points a group (R = n below 16), then a shorter
// last pass of RS points where log2 n is not a multiple of 4: n = 1024 runs
// 4 + 4 + 2 stages with 2 barriers.  The first pass reads the CTA's rows
// from device memory (coalesced: neighbouring groups hold neighbouring p)
// and the last writes them there (slot j of neighbouring groups to
// neighbouring points); in between the points cross two exchange buffers
// of re/im planes, pass p writing buffer p mod 2 through pease_swizzle (one
// buffer serves two passes): in shared memory, or in this CTA's slice of
// the scratch buffer in device memory where they do not fit.  a.table is
// the per-stage table (stockham_stage_table), read from device memory
// through the L1 cache: a pass reads each entry it needs once a group, so a
// CTA's copy of the table would move as many bytes (at 4096 points, as
// many as its row) and take the shared memory of a CTA an SM.
template <int R, int RS>
__global__ void __launch_bounds__(kThreads) fft_stockham_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  constexpr int r = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const int n = a.n, log2n = log2i(n);
  const int rows = min(a.rows, a.batch - static_cast<int>(blockIdx.x) * a.rows);
  const size_t base = static_cast<size_t>(blockIdx.x) * a.rows * n;
  const float2* tw = reinterpret_cast<const float2*>(a.table);
  float* buf = a.scratch != nullptr
                   ? a.scratch + static_cast<size_t>(blockIdx.x) * a.rows * 4 * n
                   : reinterpret_cast<float*>(smem);
  const int plane = a.rows * n;
  for (int s0 = 0, p = 0; s0 < log2n; s0 += r, ++p) {
    // pass p reads buffer (p - 1) mod 2 and writes buffer p mod 2
    const float* src_r = s0 == 0 ? a.in_r + base : buf + ((p + 1) & 1) * 2 * plane;
    const float* src_i = s0 == 0 ? a.in_i + base : src_r + plane;
    if (s0 + r >= log2n) {
      asp::stockham_groups<RS>(rows, log2n, s0, src_r, src_i, s0 > 0, a.out_r + base,
                               a.out_i + base, false, tw);
      break;
    }
    float* dst = buf + (p & 1) * 2 * plane;
    asp::stockham_groups<R>(rows, log2n, s0, src_r, src_i, s0 > 0, dst, dst + plane, true, tw);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// rfft_stockham and irfft_stockham: the half-size transform on the same passes
// ---------------------------------------------------------------------------

// A row of n = 2m real points is m complex points z[k] = x[2k] + i x[2k+1],
// so rfft_stockham runs fft_stockham_kernel's passes on the m-point rows
// with the pack in the first pass's loads: slot j of group v reads z as
// one 8-byte float2 of the row, neighbouring groups neighbouring k.  The
// untangle X[k] = E[k] + w^k O[k] pairs Z[k] with Z[(m - k) mod m], and the
// last pass puts the two in the registers of one thread: slot j of group q
// ends at k = brev(j) 2^lg + q (lg = log2 m - log2 RS), whose mirror is
// slot RS - 1 - j of group 2^lg - q (in group 0, slot brev(-brev(j) mod
// RS) of group 0; group 2^(lg-1) is its own partner too).  So unit u of a
// row runs groups u and 2^lg - u (u = 0: groups 0 and 2^(lg-1)) and writes
// the bins of both from registers, the thread of u = 0 also X[m] = Re Z[0]
// - Im Z[0], in the plain version's float32 order: no exchange, no barrier
// and no shared-memory read for the untangle.  So that a pair holds at most
// 16 points, the last pass takes log2 m mod 4 stages, or 1 after a first
// pass of 3 where log2 m is a multiple of 4 (real_stockham_passes); the
// exchange between the other passes is the complex kernel's, two buffers
// of swizzled planes (real_stockham_geometry).  n = 1024 runs 4 + 4 + 1
// stages with 2 barriers.  a.table is the m-point per-stage
// table (stockham_table(m, -1)), a.tw the n/2-point table of w^k = exp(-2
// pi i k / n), both read through the L1 cache.

// Bin k of a row, X[k] = E[k] + w^k O[k] with E = (Z[k] + C)/2, O = -i (Z[k]
// - C)/2, C = conj Z[(m - k) mod m], from z = Z[k] and zc = Z[(m - k) mod m],
// in the plain version's float32 order.
__device__ __forceinline__ void untangle_bin(float* xr, float* xi, const float2* w, int k,
                                             float2 z, float2 zc) {
  const float cr = zc.x, ci = -zc.y;
  const float er = 0.5f * (z.x + cr), ei = 0.5f * (z.y + ci);
  const float orr = 0.5f * (z.y - ci), oi = -0.5f * (z.x - cr);
  const float2 wk = __ldg(w + k);
  xr[k] = er + wk.x * orr - wk.y * oi;
  xi[k] = ei + wk.x * oi + wk.y * orr;
}

// rfft_stockham's last pass, from stage s0, with the untangle (above);
// kOne: the row is one group (m = RS, one pass), its own partner.
template <int RS, bool kOne, class Load>
__device__ __forceinline__ void untangle_pass(const asp::FftArgs& a, int row0, int rows,
                                              int log2m, int s0, Load load, bool swz_in,
                                              const float2* tw) {
  constexpr int rs = asp::pass_bits(RS);
  const int m = 1 << log2m, lg = log2m - rs;
  const int lu = lg > 0 ? lg - 1 : 0;  // log2 of the units a row
  const float2* w = reinterpret_cast<const float2*>(a.tw);
  int rsw[rs];
  asp::stockham_read_offsets<RS>(rsw, log2m, s0, swz_in);
  for (int u = threadIdx.x; u < rows << lu; u += blockDim.x) {
    const int row = u >> lu, q = u & ((1 << lu) - 1);
    float* xr = a.out_r + static_cast<size_t>(row0 + row) * (m + 1);
    float* xi = a.out_i + static_cast<size_t>(row0 + row) * (m + 1);
    float2 z[RS];
    asp::stockham_group<RS>(z, (row << lg) | q, log2m, s0, load, swz_in, rsw, tw);
    if (q == 0) {
      xr[m] = z[0].x - z[0].y;
      xi[m] = 0.0f;
    }
    if constexpr (kOne) {
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        untangle_bin(xr, xi, w, asp::brev_bits(j, rs), z[j],
                     z[asp::brev_bits((RS - asp::brev_bits(j, rs)) & (RS - 1), rs)]);
      }
      continue;
    }
    const bool own = q == 0;  // groups 0 and 2^(lg-1): each its own partner
    const int q2 = own ? 1 << (lg - 1) : (1 << lg) - q;
    float2 y[RS];
    asp::stockham_group<RS>(y, (row << lg) | q2, log2m, s0, load, swz_in, rsw, tw);
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const int k = asp::brev_bits(j, rs) << lg;
      const float2 zc = own ? z[asp::brev_bits((RS - asp::brev_bits(j, rs)) & (RS - 1), rs)]
                            : y[RS - 1 - j];
      const float2 yc = own ? y[RS - 1 - j] : z[RS - 1 - j];
      untangle_bin(xr, xi, w, k + q, z[j], zc);
      untangle_bin(xr, xi, w, k + q2, y[j], yc);
    }
  }
}

template <int R, int RS>
__global__ void __launch_bounds__(kThreads) rfft_stockham_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  constexpr int rs = asp::pass_bits(RS);
  const int m = a.n / 2, log2m = log2i(m);
  const int row0 = blockIdx.x * a.rows;
  const int rows = min(a.rows, a.batch - row0);
  const float2* tw = reinterpret_cast<const float2*>(a.table);
  float* buf = a.scratch != nullptr
                   ? a.scratch + static_cast<size_t>(blockIdx.x) * a.rows * 4 * m
                   : reinterpret_cast<float*>(smem);
  const int plane = a.rows * m;
  const float2* x = reinterpret_cast<const float2*>(a.in_r) + static_cast<size_t>(row0) * m;
  const auto pack = [x](int i) { return x[i]; };
  if constexpr (R == RS) {  // m <= 16: one pass
    untangle_pass<RS, true>(a, row0, rows, log2m, 0, pack, false, tw);
    return;
  }
  const float* src = buf;
  int s0 = 0, p = 0;
  if (((log2m - rs) & 3) == 3) {  // where log2 m is a multiple of 4: a pass of 8 first
    asp::stockham_groups<8>(rows, log2m, 0, pack, false, asp::PlanarOut{buf, buf + plane}, true,
                            tw);
    __syncthreads();
    s0 = 3;
    p = 1;
  }
  for (; s0 + rs < log2m; s0 += 4, ++p) {
    float* dst = buf + (p & 1) * 2 * plane;
    const asp::PlanarOut ex{dst, dst + plane};
    if (s0 == 0) {
      asp::stockham_groups<R>(rows, log2m, 0, pack, false, ex, true, tw);
    } else {
      asp::stockham_groups<R>(rows, log2m, s0, asp::PlanarIn{src, src + plane}, true, ex, true,
                              tw);
    }
    __syncthreads();
    src = dst;
  }
  untangle_pass<RS, false>(a, row0, rows, log2m, s0, asp::PlanarIn{src, src + plane}, true,
                           tw);
}

// irfft_stockham: the inverse on the same passes, the untangle's pass first
// (n = 1024: 1 + 4 + 4 stages, 2 barriers; where log2 m is a multiple of 4,
// 1 + 3 + 4 + ...).  The first pass (stages 0 ..
// rs - 1, RS = 2^rs points a group) forms its points as it loads them:
// z[k] = E[k] + i O[k], E = (S[k] + conj S[m - k])/2, O = (S[k] - conj S[m -
// k])/2 conj(w^k), with Im S[0] and Im S[m] dropped, in the plain version's
// float32 order.  Slot j of group q holds k = j 2^pw + q (pw = log2 m - rs),
// whose mirror m - k is slot RS - 1 - j of group 2^pw - q (in group 0, slot
// RS - j, and S[m] for slot 0; group 2^(pw-1) is its own partner), so unit
// u of a row runs groups u and 2^pw - u (u = 0: groups 0 and 2^(pw-1)) and
// reads each bin once from the (sr, si) planes, through the L1 cache.  The
// last pass writes y[2k], y[2k+1] = z[k] / m as one 8-byte float2 in natural
// order (1/m is a power of two: the product is the plain version's
// quotient).  The exchange between the passes is rfft's.  a.table is
// stockham_table(m, +1), a.tw the n/2-point table.

// z[k] from S[k] = s and S[m - k] = sc (imaginary parts already dropped
// where they must be), in the plain version's float32 order.
__device__ __forceinline__ float2 retangle_bin(const float2* w, int k, float2 s, float2 sc) {
  const float cr = sc.x, ci = -sc.y;
  const float er = 0.5f * (s.x + cr), ei = 0.5f * (s.y + ci);
  const float dr = 0.5f * (s.x - cr), di = 0.5f * (s.y - ci);
  const float2 wk = __ldg(w + k);  // conj(w^k) = (wc, ws)
  const float wc = wk.x, ws = -wk.y;
  const float orr = dr * wc - di * ws, oi = dr * ws + di * wc;
  return make_float2(er - oi, ei + orr);
}

// irfft_stockham's first pass with the untangle (above), its points stored
// through `store` (the exchange, or the scaled row for a one-pass row);
// kOne: the row is one group (m = RS), its own partner.
template <int RS, bool kOne, class Store>
__device__ __forceinline__ void retangle_pass(const asp::FftArgs& a, int row0, int rows,
                                              int log2m, Store store, bool swz_out,
                                              const float2* tw) {
  constexpr int rs = asp::pass_bits(RS);
  const int m = 1 << log2m, pw = log2m - rs;
  const int lu = pw > 0 ? pw - 1 : 0;  // log2 of the units a row
  const float2* w = reinterpret_cast<const float2*>(a.tw);
  int wsw[rs];
  asp::stockham_write_offsets<RS>(wsw, log2m, swz_out);
  for (int u = threadIdx.x; u < rows << lu; u += blockDim.x) {
    const int row = u >> lu, q = u & ((1 << lu) - 1);
    const float* sr = a.in_r + static_cast<size_t>(row0 + row) * (m + 1);
    const float* si = a.in_i + static_cast<size_t>(row0 + row) * (m + 1);
    const bool own = q == 0;  // groups 0 and 2^(pw-1): each its own partner
    const float2 sm = make_float2(__ldg(sr + m), 0.0f);  // S[m], the mirror of S[0]
    float2 s[RS];
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      s[j] = make_float2(__ldg(sr + ((j << pw) | q)), __ldg(si + ((j << pw) | q)));
    }
    if (own) s[0].y = 0.0f;  // Im S[0]
    if constexpr (kOne) {
      float2 z[RS];
#pragma unroll
      for (int j = 0; j < RS; ++j) z[j] = retangle_bin(w, j, s[j], j == 0 ? sm : s[RS - j]);
      asp::stockham_pass<RS>(z, tw, 0, 0);
      asp::stockham_put<RS>(z, row << log2m, swz_out, wsw, store);
      continue;
    }
    const int q2 = own ? 1 << (pw - 1) : (1 << pw) - q;
    float2 t[RS];
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      t[j] = make_float2(__ldg(sr + ((j << pw) | q2)), __ldg(si + ((j << pw) | q2)));
    }
    float2 z[RS], y[RS];
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const float2 sc = j == 0 ? (own ? sm : t[RS - 1]) : own ? s[RS - j] : t[RS - 1 - j];
      const float2 tc = own ? t[RS - 1 - j] : s[RS - 1 - j];
      z[j] = retangle_bin(w, (j << pw) | q, s[j], sc);
      y[j] = retangle_bin(w, (j << pw) | q2, t[j], tc);
    }
    asp::stockham_pass<RS>(z, tw, 0, 0);
    asp::stockham_put<RS>(z, (row << log2m) | q, swz_out, wsw, store);
    asp::stockham_pass<RS>(y, tw, 0, 0);
    asp::stockham_put<RS>(y, (row << log2m) | q2, swz_out, wsw, store);
  }
}

// Three CTAs an SM (at most 80 registers) where the exchange lets three in:
// the first pass holds two groups' points and their bins, and at RS = 8
// ptxas would take 106 registers (two CTAs) where it now spills 28 bytes.
template <int R, int RS>
__global__ void __launch_bounds__(kThreads, R == 16 && RS < 16 ? 3 : 1)
    irfft_stockham_kernel(asp::FftArgs a) {
  extern __shared__ float4 smem[];
  constexpr int rs = asp::pass_bits(RS);
  const int m = a.n / 2, log2m = log2i(m);
  const int row0 = blockIdx.x * a.rows;
  const int rows = min(a.rows, a.batch - row0);
  const float2* tw = reinterpret_cast<const float2*>(a.table);
  float* buf = a.scratch != nullptr
                   ? a.scratch + static_cast<size_t>(blockIdx.x) * a.rows * 4 * m
                   : reinterpret_cast<float*>(smem);
  const int plane = a.rows * m;
  const float inv = 1.0f / static_cast<float>(m);
  float2* yo = reinterpret_cast<float2*>(a.out_r) + static_cast<size_t>(row0) * m;
  const auto scaled = [yo, inv](int i, float2 v) { yo[i] = make_float2(v.x * inv, v.y * inv); };
  if constexpr (R == RS) {  // m <= 16: one pass
    retangle_pass<RS, true>(a, row0, rows, log2m, scaled, false, tw);
    return;
  }
  retangle_pass<RS, false>(a, row0, rows, log2m, asp::PlanarOut{buf, buf + plane}, true, tw);
  __syncthreads();
  const float* src = buf;
  int s0 = rs, p = 1;
  if (((log2m - rs) & 3) == 3) {  // where log2 m is a multiple of 4
    float* dst = buf + 2 * plane;
    asp::stockham_groups<8>(rows, log2m, s0, asp::PlanarIn{src, src + plane}, true,
                            asp::PlanarOut{dst, dst + plane}, true, tw);
    __syncthreads();
    src = dst;
    s0 += 3;
    ++p;
  }
  for (;; s0 += 4, ++p) {
    const asp::PlanarIn in{src, src + plane};
    if (s0 + 4 >= log2m) {
      asp::stockham_groups<R>(rows, log2m, s0, in, true, scaled, false, tw);
      break;
    }
    float* dst = buf + (p & 1) * 2 * plane;
    asp::stockham_groups<R>(rows, log2m, s0, in, true, asp::PlanarOut{dst, dst + plane}, true,
                            tw);
    __syncthreads();
    src = dst;
  }
}

enum Kind { kComplex, kRfft, kIrfft };

template <int R, int RS>
void (*kind_kernel(Kind kind))(asp::FftArgs) {
  return kind == kComplex ? fft_stockham_kernel<R, RS>
         : kind == kRfft  ? rfft_stockham_kernel<R, RS>
                          : irfft_stockham_kernel<R, RS>;
}

// The instantiation for an m-point transform: R = m below 16 points, else
// 16 with a shorter pass of RS = 2^(log2 m mod 4) points (16 where that is
// 0; the real kernels pair their untangle pass's groups, so past 16 points
// they take RS = 2 there, after a pass of 8).
void (*stockham_kernel(Kind kind, int m))(asp::FftArgs) {
  const int short_pass = __builtin_ctz(static_cast<unsigned>(m)) % 4;
  return m == 2 ? kind_kernel<2, 2>(kind)
         : m == 4 ? kind_kernel<4, 4>(kind)
         : m == 8 ? kind_kernel<8, 8>(kind)
         : short_pass == 1 || (short_pass == 0 && kind != kComplex && m > 16)
             ? kind_kernel<16, 2>(kind)
         : short_pass == 2 ? kind_kernel<16, 4>(kind)
         : short_pass == 3 ? kind_kernel<16, 8>(kind)
                           : kind_kernel<16, 16>(kind);
}

int launch(void (*kernel)(asp::FftArgs), const asp::FftArgs* a, int smem_bytes,
           int device, void* stream, int threads = kThreads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a->batch + a->rows - 1) / a->rows;
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStacked>
int launch_radix2(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  void (*kernel)(asp::FftArgs) = a->n >= 16 ? fft_radix2_lanes_kernel<16, kStacked>
                                 : a->n == 8 ? fft_radix2_lanes_kernel<8, kStacked>
                                 : a->n == 4 ? fft_radix2_lanes_kernel<4, kStacked>
                                             : fft_radix2_lanes_kernel<2, kStacked>;
  return launch(kernel, a, smem_bytes, device, stream);
}

}  // namespace

extern "C" {

// Each launches on `stream` (a cudaStream_t) and returns cudaGetLastError()
// after the launch: 0 on success.  Nothing is synchronized or allocated.
int asp_fft_stockham(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(stockham_kernel(kComplex, a->n), a, smem_bytes, device, stream);
}

int asp_rfft_stockham(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(stockham_kernel(kRfft, a->n / 2), a, smem_bytes, device, stream);
}

int asp_irfft_stockham(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch(stockham_kernel(kIrfft, a->n / 2), a, smem_bytes, device, stream);
}

int asp_fft_fourstep(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  const int n = a->n;
  void (*kernel)(asp::FftArgs) = n < 8       ? fft_fourstep_kernel<kColsPad>
                                 : n <= 128  ? fft_fourstep_kernel<kColsFma1>
                                 : n == 256  ? fft_fourstep_kernel<kColsFma2>
                                 : n == 512  ? fft_fourstep_kernel<kColsFma4>
                                 : n <= 4096 ? fft_fourstep_kernel<kColsInPlace>
                                             : fft_fourstep_kernel<kColsGlobal>;
  return launch(kernel, a, smem_bytes, device, stream, kFourstepThreads);
}

int asp_fft_radix2_lanes(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch_radix2<false>(a, smem_bytes, device, stream);
}

int asp_fft_radix2_stages(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  return launch_radix2<true>(a, smem_bytes, device, stream);
}

int asp_fft_pease_lanes(const asp::FftArgs* a, int smem_bytes, int device, void* stream) {
  const int n = a->n, short_pass = __builtin_ctz(static_cast<unsigned>(n)) % 4;
  void (*kernel)(asp::FftArgs) = n == 2 ? fft_pease_kernel<2, 2>
                                 : n == 4 ? fft_pease_kernel<4, 4>
                                 : n == 8 ? fft_pease_kernel<8, 8>
                                 : short_pass == 1 ? fft_pease_kernel<16, 2>
                                 : short_pass == 2 ? fft_pease_kernel<16, 4>
                                 : short_pass == 3 ? fft_pease_kernel<16, 8>
                                                   : fft_pease_kernel<16, 16>;
  return launch(kernel, a, smem_bytes, device, stream);
}

}  // extern "C"
