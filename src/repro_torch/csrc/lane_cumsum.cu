// lane_cumsum — inclusive cumsum down the rows of a tall, thin [S, K] array.
//
// Replaces: src/repro/kernels/lane_cumsum.py::lane_cumsum (body _kernel).
// The TPU kernel walks [1024, K] row tiles one after another on one core,
// K padded to 128 lanes, carrying the running per-lane total in VMEM from
// one grid step to the next. Hopper's blocks run in parallel and in no set
// order, so the carry is passed between blocks through device memory
// instead: one launch, a single pass with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016).
//
// DFEP's rank cumsum is the caller: [2·e_pad, K] and [V, K] int32 0/1 with
// K = 16 ([1.9 M, 16], 122 MB, at dblp 1.0). Bound on this card: bytes.
// Each element is read once and written once and costs one add, so the
// H100's 3.35 TB/s limits it, and the input does not fit the 50 MB L2. The
// design reads the input exactly once:
//
//   * Tiles. A tile is R rows by up to 256·VEC columns, contiguous in memory
//     when it spans all K (always, for K ≤ 256·VEC). Blocks take tile ids
//     from an atomicAdd counter, so every predecessor of a tile has started
//     and the look-back below always makes progress.
//   * Loads. Thread (rg, tc) owns column vector tc (VEC = 4 columns, or 1
//     when K % 4 != 0 or a pointer is not 16-byte aligned) of the L = 16
//     consecutive rows of row group rg, and loads them as L independent
//     16-byte loads into registers. At K = 16 four threads read one 64-byte
//     row and a warp reads 8 such rows, every sector it fetches used.
//   * Local scan. Each thread scans its L rows in registers; the block scans
//     the row groups' totals per column in shared memory (Hillis–Steele).
//   * Look-back. The block publishes each column's tile aggregate, passes
//     a barrier (another thread publishes the column's prefix later, and
//     the barrier keeps the aggregate from landing after it), then every
//     column looks back at once: W lanes of a warp per column (16 at
//     K = 16) read the status words of W predecessor tiles together, sum
//     their aggregates up to the nearest one that holds an inclusive prefix,
//     and move W tiles further back while none does. Each column's
//     inclusive prefix is published as soon as it is known. (One warp per
//     column, taking K = 16's columns two at a time, was slower: the block
//     waited on two look-backs in a row.)
//   * Status words. The flag and the 32-bit value of one (tile, column)
//     share one 64-bit word written with one store, so a reader never sees
//     a flag without its value and no fence is needed. The wrapper zeroes
//     them (and the tile counter) on every call with torch.zeros, one memset
//     on the same stream, so a CUDA-graph replay starts from clean flags.
//   * Output. Each thread adds the tile's exclusive prefix and its row
//     group's offset to its registers and writes them with 16-byte stores.
//
// int32 is exact. float32 sums in another order than a sequential scan
// (per thread, per row group, per tile), so it differs from torch.cumsum by
// rounding. Nothing is allocated here: the wrapper hands in the output and
// the zeroed scratch, whose size lane_cumsum_scratch_words gives.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;  // L
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// Tile layout: cwv column vectors of a slab (min(K / VEC, kThreads)),
// g = kThreads / cwv row groups of kRowsPerThread rows, R = g ·
// kRowsPerThread rows a tile; a row tile is n_slabs tiles side by side.
struct Layout {
  long long S;
  int K, R, cwv, g, n_slabs;
};

Layout make_layout(long long S, int K, int vec) {
  const int kv = K / vec;
  Layout L;
  L.S = S;
  L.K = K;
  L.cwv = kv < kThreads ? kv : kThreads;
  L.g = kThreads / L.cwv;
  L.R = L.g * kRowsPerThread;
  L.n_slabs = (kv + L.cwv - 1) / L.cwv;
  return L;
}

// the scratch: the tile counter (one word), then a status word per
// (row tile, column)
long long scratch_words(const Layout& L) {
  return 1 + (L.S + L.R - 1) / L.R * L.K;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ unsigned bits_of(int x) {
  return static_cast<unsigned>(x);
}
__device__ __forceinline__ unsigned bits_of(float x) {
  return __float_as_uint(x);
}
template <typename T> __device__ __forceinline__ T from_bits(unsigned b);
template <> __device__ __forceinline__ int from_bits<int>(unsigned b) {
  return static_cast<int>(b);
}
template <> __device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long flag,
                                        unsigned value) {
  // one 64-bit store: flag and value become visible together
  *reinterpret_cast<volatile unsigned long long*>(word) = flag | value;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    lane_cumsum_kernel(const T* __restrict__ x, T* __restrict__ out,
                       unsigned long long* __restrict__ status,
                       int* __restrict__ counter, Layout L) {
  using V = Vec<T, VEC>;
  constexpr int LR = kRowsPerThread;
  __shared__ V tot[kThreads];          // row-group totals, then their scan
  __shared__ T excl[kThreads * VEC];   // the tile's prefix, per column
  __shared__ int tile_id;

  if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1);
  __syncthreads();
  const long long tile = tile_id;
  const long long rt = tile / L.n_slabs;           // row tile
  const int slab = static_cast<int>(tile % L.n_slabs);
  const int kv = L.K / VEC;                        // column vectors in a row
  const int cv0 = slab * L.cwv;                    // first of this slab
  const int ncv = min(L.cwv, kv - cv0);            // column vectors here
  const int ncol = ncv * VEC;                      // columns here
  const int tc = threadIdx.x % L.cwv, rg = threadIdx.x / L.cwv;
  const bool active = rg < L.g && tc < ncv;
  const long long r0 = rt * L.R + static_cast<long long>(rg) * LR;

  // load L rows of this thread's column vector (zeros past the end)
  V r[LR];
#pragma unroll
  for (int j = 0; j < LR; ++j) {
    const long long row = r0 + j;
    if (active && row < L.S) {
      r[j] = *reinterpret_cast<const V*>(x + row * L.K + (cv0 + tc) * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) r[j].v[i] = T(0);
    }
  }
  // inclusive scan of the thread's rows, in registers
#pragma unroll
  for (int j = 1; j < LR; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[j].v[i] += r[j - 1].v[i];
  tot[threadIdx.x] = r[LR - 1];
  __syncthreads();
  // inclusive scan of the row-group totals down each column (Hillis-Steele)
  for (int off = 1; off < L.g; off <<= 1) {
    V add;
#pragma unroll
    for (int i = 0; i < VEC; ++i) add.v[i] = T(0);
    if (rg < L.g && rg >= off) add = tot[threadIdx.x - off * L.cwv];
    __syncthreads();
    if (rg < L.g && rg >= off)
#pragma unroll
      for (int i = 0; i < VEC; ++i) tot[threadIdx.x].v[i] += add.v[i];
    __syncthreads();
  }
  // the tile's aggregate is the last row group's inclusive total: publish it
  // (tile 0's aggregate is already its inclusive prefix)
  const V* agg = &tot[(L.g - 1) * L.cwv];
  unsigned long long* st_row = status + rt * L.K + cv0 * VEC;
  if (rt == 0) {
    for (int c = threadIdx.x; c < ncol; c += kThreads) {
      publish(st_row + c, kPrefix, bits_of(agg[c / VEC].v[c % VEC]));
      excl[c] = T(0);
    }
  } else {
    for (int c = threadIdx.x; c < ncol; c += kThreads)
      publish(st_row + c, kAggregate, bits_of(agg[c / VEC].v[c % VEC]));
    // another thread publishes column c's prefix below: the barrier orders
    // the two stores to the word, so the prefix is the one that stays
    __syncthreads();
    // look-back: W lanes of a warp per column, all columns at once, W
    // predecessors a step (W: the largest power of two up to 32 with
    // W · ncol ≤ kThreads, or 1 and several passes for wider slabs)
    int W = 32;
    while (W > 1 && W * ncol > kThreads) W >>= 1;
    const int lane = threadIdx.x % 32, wl = lane % W;
    const unsigned group_bits = W == 32 ? ~0u : (1u << W) - 1;
    const int shift = lane - wl;  // this group's first lane
    for (int c0 = 0; c0 < ncol; c0 += kThreads / W) {
      const int c = c0 + static_cast<int>(threadIdx.x) / W;
      bool done = c >= ncol;
      T sum = T(0);
      long long pred = rt - 1 - wl;
      while (!__all_sync(~0u, done)) {
        unsigned long long w = kPrefix;  // before tile 0: a prefix of 0
        if (!done && pred >= 0) {
          const unsigned long long* p = status + pred * L.K + cv0 * VEC + c;
          do {
            w = peek(p);
          } while ((w >> 32) == 0);
        }
        const unsigned prefixes =
            (__ballot_sync(~0u, !done && (w >> 32) == 2) >> shift) &
            group_bits;
        // lanes up to the nearest prefix (all W if none) count
        const int last = prefixes ? __ffs(prefixes) - 1 : W - 1;
        T v = !done && wl <= last ? from_bits<T>(static_cast<unsigned>(w))
                                  : T(0);
        for (int off = W >> 1; off > 0; off >>= 1)
          v += __shfl_xor_sync(~0u, v, off);
        if (!done) {
          sum += v;
          done = prefixes != 0;
        }
        pred -= W;
      }
      if (wl == 0 && c < ncol) {
        excl[c] = sum;
        publish(st_row + c, kPrefix,
                bits_of(sum + agg[c / VEC].v[c % VEC]));
      }
    }
  }
  __syncthreads();
  if (!active) return;
  // this thread's offset: the tile's prefix plus the row groups before it
  V base;
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    base.v[i] = excl[tc * VEC + i] +
                (rg > 0 ? tot[threadIdx.x - L.cwv].v[i] : T(0));
#pragma unroll
  for (int j = 0; j < LR; ++j) {
    const long long row = r0 + j;
    if (row < L.S) {
      V o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = r[j].v[i] + base.v[i];
      *reinterpret_cast<V*>(out + row * L.K + (cv0 + tc) * VEC) = o;
    }
  }
}

template <typename T>
int launch(const void* x, void* out, void* scratch, long long S, int K,
           int vec, cudaStream_t st) {
  const Layout L = make_layout(S, K, vec);
  const long long n_tiles = (S + L.R - 1) / L.R * L.n_slabs;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int* counter = static_cast<int*>(scratch);
  unsigned long long* status = static_cast<unsigned long long*>(scratch) + 1;
  const unsigned blocks = static_cast<unsigned>(n_tiles);
  if (vec == 4)
    lane_cumsum_kernel<T, 4><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), status, counter, L);
  else
    lane_cumsum_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), status, counter, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of a tile, and the zeroed 64-bit words of scratch that lane_cumsum
// needs, for an [S, K] array loaded vec columns at a time (the layout's one
// owner: the wrapper sizes its scratch with these).
// -1 for a K or vec that lane_cumsum refuses.
extern "C" long long lane_cumsum_tile_rows(int K, int vec) {
  if (K <= 0 || (vec != 1 && vec != 4) || K % vec != 0) return -1;
  return make_layout(1, K, vec).R;
}

extern "C" long long lane_cumsum_scratch_words(long long S, int K, int vec) {
  if (S < 0 || K <= 0 || (vec != 1 && vec != 4) || K % vec != 0) return -1;
  return scratch_words(make_layout(S, K, vec));
}

// Plain C entry point (loaded with ctypes). x and out are [S, K] row-major;
// vec (4 or 1) is the columns a thread loads at once; scratch holds
// lane_cumsum_scratch_words(S, K, vec) zeroed 64-bit words. dtype 0 is
// int32, 1 is float32. vec 4 needs K % 4 == 0 and x and out 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError() as an int
// (0 on success).
extern "C" int lane_cumsum(const void* x, void* out, void* scratch,
                           long long S, int K, int vec, int dtype,
                           void* stream) {
  if (S <= 0 || K <= 0) return 0;
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (K % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<int>(x, out, scratch, S, K, vec, st);
  if (dtype == 1)
    return launch<float>(x, out, scratch, S, K, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
