// Batched complex FFT fed by an explicit copy ring, for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernel kernels/fft_kernel.py
// fft_stockham_manual: fft_stockham_lanes' transform (planar (B, n) re/im
// rows, natural order in and out, unnormalized, sign -1 forward and +1
// inverse) with the tile pipeline taken away from the compiler.  The TPU
// kernel runs one grid step, keeps input and output in HBM and walks the
// row tiles in a fori_loop, with NBUF = 3 VMEM buffers filled by
// make_async_copy under DMA semaphores; here that is the Hopper form of
// the same ring: bulk asynchronous copies (the TMA engine's 1-D form)
// completing on an mbarrier per slot.
//
// Design.  A persistent grid: at most the CTAs that fit on the card at
// once (resident CTAs per SM, from shared memory and registers, times the
// SM count), each walking the row tiles t = blockIdx.x, t += gridDim.x.
// A tile is `rows` = max(1, 1024 / n) rows, and a CTA has one thread per
// 16 points of a tile, at most 256 (manual_launch).  Shared memory holds
// the ring (nbuf slots, each a tile's re and im planes), one work tile and
// the slots' mbarriers; the per-stage twiddle table is read from device
// memory through the L1 cache.  One elected thread fills a slot with two
// bulk copies (re, im) after mbarrier.arrive.expect_tx of both planes'
// bytes; every thread waits on the slot's phase parity, (k / nbuf) & 1 for
// the CTA's k-th tile.  The stages are fft_stockham_lanes' register passes
// (csrc/fft_regs.cuh: four radix-2 stages a pass in registers, a shorter
// last one), ping-ponging between the slot and the work tile, pass p
// reading the slot for even p: the first pass reads the slot in natural
// order (as the bulk copy leaves it), the last writes natural order (for
// the bulk store), and the exchanges in between go through pease_swizzle.
// So the result ends in the work tile for an odd number of passes
// (`in_work`: n <= 16 and 512 <= n <= 4096), in the slot for an even one,
// and leaves by bulk stores from there.  A barrier follows each pass, so a
// tile takes ceil(log2 n / 4) of them (3 at n = 1024, where the radix-2
// loop took 10).  The hazards, each with its guard:
// - write after read on a slot: the refill of slot k % nbuf for tile
//   k + nbuf is issued only after the last pass's barrier (every thread
//   has read and written the slot), behind fence.proxy.async from the
//   issuing thread; when the result sits in the slot (an even number of
//   passes), also behind cp.async.bulk.wait_group.read of the store that
//   reads it;
// - generic writes seen by the async proxy: every thread runs
//   fence.proxy.async before the last pass's barrier, then the bulk store
//   is issued;
// - the work tile reused while a store reads it (an odd number of
//   passes): the next tile's first pass writes the work tile, so the
//   issuing thread waits with wait_group.read before the barrier that
//   precedes it; with an even number the store reads the slot, and the
//   work tile, which only the passes touch, is free once the last pass's
//   barrier is behind;
// - alignment: a bulk copy needs 16-byte-aligned addresses and a size
//   that is a multiple of 16.  Tile offsets are multiples of 4 KB and the
//   launcher refuses misaligned planes (the wrapper copies them), so only
//   a tail tile at n = 2 with an odd number of rows can miss: its slot
//   completes on a plain arrive, and the threads load and store it with
//   ordinary accesses;
// - drain: the issuing thread waits for every store before the CTA exits.
// Tiles past the batch are never fetched.
//
// What bounds it on an H100: a complex transform moves 16 n bytes a row
// (at 4096 rows x 1024 points 67 MB, 20 us at 3.35 TB/s) against
// 5 n log2 n flops (3 us at 67 TFLOP/s): device memory.  The ring keeps
// up to nbuf tiles in flight per CTA while the passes run, where the grid
// kernel loads its rows with ordinary loads in its first pass.  Shared
// memory: (nbuf + 1) 8 rows n + 8 nbuf bytes; the ring is 3 deep up to
// n = 4096 and 2 deep at 8192, and n = 16384 does not fit (the wrapper
// raises before dispatch).  The small rows of a tile make the slot's
// natural-order accesses collide on shared-memory banks below n = 512 (16
// ways at n = 16); from n = 512 on every access of the passes is
// conflict-free.

#include <cstdint>

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace asp {

// The kernel's arguments; kernels/fft_kernel.py (FftManualArgs) mirrors it.
struct FftManualArgs {
  const float* in_r;  // re plane (B, n)
  const float* in_i;  // im plane (B, n)
  float* out_r;       // re plane (B, n)
  float* out_i;       // im plane (B, n)
  const float* tw;    // the per-stage table of `sign` (stockham_stage_table)
  int batch;          // B rows
  int n;              // points per row
  int sign;           // -1 forward, +1 inverse (the table's)
  int rows;           // rows per tile
  int nbuf;           // ring slots in shared memory
  int grid;           // CTAs launched
};

}  // namespace asp

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int log2i(int m) { return __ffs(m) - 1; }

// ---- the copy ring's PTX -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialization visible to the async proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Order this thread's generic-proxy accesses to shared memory before the
// async proxy's (bulk copies) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Device memory -> shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory -> device memory, in the current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until every committed store has read its shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Wait until every committed store has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The CTA's k-th tile: tile index, first point of its planes, its rows.
struct Tile {
  int t;
  size_t base;
  int rows;
  bool bulk;  // its planes' bytes are a multiple of 16: bulk copies
};

__device__ __forceinline__ Tile tile_of(const asp::FftManualArgs& a, int k) {
  Tile tl;
  tl.t = blockIdx.x + k * gridDim.x;
  tl.base = static_cast<size_t>(tl.t) * a.rows * a.n;
  tl.rows = min(a.rows, a.batch - tl.t * a.rows);
  tl.bulk = ((tl.rows * a.n) & 3) == 0;
  return tl;
}

// Issued by the elected thread: fill `slot` (re plane, then im plane at
// +plane floats) with the CTA's k-th tile, or arrive on its barrier
// without a copy when the tile is not bulk-copyable.
__device__ __forceinline__ void fill(const asp::FftManualArgs& a, int k, float* slot, int plane,
                                     uint64_t* bar) {
  const Tile tl = tile_of(a, k);
  if (!tl.bulk) {
    mbar_arrive(bar);
    return;
  }
  const uint32_t bytes = static_cast<uint32_t>(tl.rows * a.n) * 4u;
  mbar_expect_tx(bar, 2u * bytes);
  bulk_load(slot, a.in_r + tl.base, bytes, bar);
  bulk_load(slot + plane, a.in_i + tl.base, bytes, bar);
}

// R points a group in full passes (R = n below 16), RS in the last pass
// (a shorter one where log2 n is not a multiple of 4), as fft_stockham_lanes.
template <int R, int RS>
__global__ void __launch_bounds__(kThreads) fft_stockham_manual_kernel(asp::FftManualArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int r = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const int n = a.n, log2n = log2i(n);
  const int plane = a.rows * n;  // floats in one plane of a tile
  const int tiles = (a.batch + a.rows - 1) / a.rows;
  const int mine = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int nbuf = min(a.nbuf, mine);
  float* ring = reinterpret_cast<float*>(smem);  // a.nbuf slots of 2 planes
  float* work = ring + 2 * a.nbuf * plane;       // 2 planes
  uint64_t* full = reinterpret_cast<uint64_t*>(work + 2 * plane);
  const bool leader = threadIdx.x == 0;
  const int passes = (log2n + r - 1) / r;
  const bool in_work = (passes & 1) != 0;  // an odd number of passes ends in the work tile
  const float2* tw = reinterpret_cast<const float2*>(a.tw);

  if (leader) {
    for (int s = 0; s < nbuf; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (leader) {
    for (int k = 0; k < nbuf; ++k) fill(a, k, ring + 2 * k * plane, plane, full + k);
  }

  for (int k = 0; k < mine; ++k) {
    const Tile tl = tile_of(a, k);
    const int slot = k % nbuf;
    float* xr = ring + 2 * slot * plane;
    float* xi = xr + plane;
    const int pts = tl.rows * n;
    mbar_wait(full + slot, static_cast<uint32_t>(k / nbuf) & 1u);
    if (!tl.bulk) {
      for (int i = threadIdx.x; i < pts; i += blockDim.x) {
        xr[i] = a.in_r[tl.base + i];
        xi[i] = a.in_i[tl.base + i];
      }
    }
    if (in_work && k > 0 && leader) bulk_wait_read();  // the last tile's store read `work`
    __syncthreads();

    // pass p reads the slot for even p, the work tile for odd p, and writes the other
    for (int s0 = 0, p = 0; s0 < log2n; s0 += r, ++p) {
      float* sr = (p & 1) ? work : xr;
      float* dr = (p & 1) ? xr : work;
      if (s0 + r >= log2n) {
        asp::stockham_groups<RS>(tl.rows, log2n, s0, sr, sr + plane, s0 > 0, dr, dr + plane,
                                 false, tw);
        fence_proxy_async();  // the result, seen by the bulk store
        __syncthreads();
        break;
      }
      asp::stockham_groups<R>(tl.rows, log2n, s0, sr, sr + plane, s0 > 0, dr, dr + plane, true,
                              tw);
      __syncthreads();
    }
    const float* sr = in_work ? work : xr;
    const float* si = sr + plane;

    if (tl.bulk) {
      if (leader) {
        const uint32_t bytes = static_cast<uint32_t>(pts) * 4u;
        bulk_store(a.out_r + tl.base, sr, bytes);
        bulk_store(a.out_i + tl.base, si, bytes);
        bulk_commit();
      }
    } else {
      for (int i = threadIdx.x; i < pts; i += blockDim.x) {
        a.out_r[tl.base + i] = sr[i];
        a.out_i[tl.base + i] = si[i];
      }
    }
    if (leader && k + nbuf < mine) {
      if (!in_work) bulk_wait_read();  // the store above reads this slot
      fence_proxy_async();              // the passes' accesses to the slot before the refill
      fill(a, k + nbuf, xr, plane, full + slot);
    }
  }
  if (leader) bulk_wait_all();
}

// The kernel instantiation for a->n and its threads a CTA: one per 16
// points of a tile, at most kThreads.
struct ManualLaunch {
  void (*kernel)(asp::FftManualArgs);
  int threads;
};

ManualLaunch manual_launch(const asp::FftManualArgs* a) {
  const int n = a->n, short_pass = __builtin_ctz(static_cast<unsigned>(n)) % 4;
  void (*kernel)(asp::FftManualArgs) = n == 2 ? fft_stockham_manual_kernel<2, 2>
                                       : n == 4 ? fft_stockham_manual_kernel<4, 4>
                                       : n == 8 ? fft_stockham_manual_kernel<8, 8>
                                       : short_pass == 1 ? fft_stockham_manual_kernel<16, 2>
                                       : short_pass == 2 ? fft_stockham_manual_kernel<16, 4>
                                       : short_pass == 3 ? fft_stockham_manual_kernel<16, 8>
                                                         : fft_stockham_manual_kernel<16, 16>;
  const int threads = a->rows * n / 16;
  return {kernel, threads < kThreads ? threads : kThreads};
}

}  // namespace

extern "C" {

// The CTAs of fft_stockham_manual for a->n and a->rows that fit on `device`
// at once with `smem_bytes` of dynamic shared memory each, into *ctas.
// Returns a CUDA error code: 0 on success.
int asp_fft_manual_ctas(const asp::FftManualArgs* a, int smem_bytes, int device, int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ManualLaunch ml = manual_launch(a);
  err = cudaFuncSetAttribute(ml.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ml.kernel, ml.threads,
                                                      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *ctas = per_sm * sms;
  return 0;
}

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after
// the launch, 0 on success.  Planes that are not 16-byte aligned are
// refused (cudaErrorMisalignedAddress) before any copy is issued.
// Nothing is synchronized or allocated.
int asp_fft_stockham_manual(const asp::FftManualArgs* a, int smem_bytes, int device,
                            void* stream) {
  const uintptr_t planes = reinterpret_cast<uintptr_t>(a->in_r) |
                           reinterpret_cast<uintptr_t>(a->in_i) |
                           reinterpret_cast<uintptr_t>(a->out_r) |
                           reinterpret_cast<uintptr_t>(a->out_i);
  if (planes & 15u) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ManualLaunch ml = manual_launch(a);
  err = cudaFuncSetAttribute(ml.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ml.kernel<<<a->grid, ml.threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
