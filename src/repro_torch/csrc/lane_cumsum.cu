// lane_cumsum — inclusive cumsum down the rows of a tall, thin [S, K] array.
//
// Replaces: src/repro/kernels/lane_cumsum.py::lane_cumsum (body _kernel).
// The TPU kernel walks [1024, K] row tiles one after another on one core,
// K padded to 128 lanes, carrying the running per-lane total in VMEM from
// one grid step to the next. Hopper's blocks run in parallel and in no
// order, so nothing can be carried from one block to the next; the scan
// takes three launches instead:
//
//   1. tile totals: one block per tile of R rows sums each column of its
//      tile;
//   2. carries: one block per column scans the tile totals of that column
//      (exclusive, in place), giving each tile the sum of all rows before it;
//   3. local scan: one block per tile scans each column of its tile and adds
//      the tile's carry.
//
// DFEP's rank cumsum is the caller: [2·e_pad, K] and [V, K] int32 0/1 with
// K = 16 ([1.9 M, 16] at dblp 1.0). Its columns are contiguous rows of K
// values, so a thread that walked one column alone (what torch.cumsum along
// dim 0 does on the GPU) would read one value per 64-byte row; here a
// thread owns a column and a contiguous run of rows, and the K threads of
// one row group read whole rows, so every 32-byte sector fetched is used.
//
// Bound on this card: bytes. Each element is read once and written once and
// costs one add, so the H100's 3.35 TB/s limits it. This design reads the
// input twice (passes 1 and 3, the second often from L2) and writes it once;
// a single pass with decoupled look-back would read it once.
//
// int32 is exact. float32 sums in another order than a sequential scan
// (column partials per row group, then per tile), so it differs from
// torch.cumsum by rounding. Nothing is allocated here: the wrapper hands in
// the output and an [n_tiles, K] scratch for the tile totals.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Thread layout of the tile passes (computed on the host, see the entry
// point): cw = min(K, kThreads) columns are handled at once; for K <=
// kThreads there are g = kThreads / K row groups, thread t owns column
// t % cw and row group t / cw, and a group is l = ceil(R / g) contiguous
// rows of the tile. For larger K, g = 1 and a thread owns columns t,
// t + cw, ...
struct Layout {
  long long S;
  int K, R, cw, g, l;
};

template <typename T>
__device__ __forceinline__ T sum_rows(const T* __restrict__ x, long long r0,
                                      long long r1, int K, int c) {
  T s = T(0);
#pragma unroll 8
  for (long long r = r0; r < r1; ++r) s += x[r * K + c];
  return s;
}

// The rows [r0, r1) a thread's row group covers in tile `tile`.
__device__ __forceinline__ void group_rows(const Layout& L, long long tile,
                                           int rg, long long* r0,
                                           long long* r1) {
  const long long tile0 = tile * L.R;
  long long end = tile0 + L.R;
  if (end > L.S) end = L.S;
  long long b = tile0 + static_cast<long long>(rg) * L.l;
  long long e = b + L.l;
  if (b > end) b = end;
  if (e > end) e = end;
  *r0 = b;
  *r1 = e;
}

template <typename T>
__global__ void tile_totals_kernel(const T* __restrict__ x, T* __restrict__ tot,
                                   Layout L) {
  __shared__ T part[kThreads];
  const long long tile = blockIdx.x;
  const int tc = threadIdx.x % L.cw, rg = threadIdx.x / L.cw;
  long long r0, r1;
  group_rows(L, tile, rg, &r0, &r1);
  if (L.g == 1) {
    for (int c = tc; c < L.K; c += L.cw)
      tot[tile * L.K + c] = sum_rows(x, r0, r1, L.K, c);
    return;
  }
  part[threadIdx.x] = sum_rows(x, r0, r1, L.K, tc);  // cw == K here
  __syncthreads();
  if (rg == 0) {
    T s = T(0);
    for (int j = 0; j < L.g; ++j) s += part[j * L.cw + tc];
    tot[tile * L.K + tc] = s;
  }
}

// One block per column: the exclusive scan of that column's tile totals,
// written over them. Each thread sums a contiguous chunk of tiles, the
// block scans the chunk sums in shared memory, then each thread walks its
// chunk again writing the running sum.
template <typename T>
__global__ void carry_kernel(T* __restrict__ tot, long long n_tiles, int K) {
  __shared__ T s[kThreads];
  const int c = blockIdx.x;
  const long long chunk = (n_tiles + kThreads - 1) / kThreads;
  const long long t0 = threadIdx.x * chunk;
  long long t1 = t0 + chunk;
  if (t1 > n_tiles) t1 = n_tiles;
  T mine = T(0);
  for (long long t = t0; t < t1; ++t) mine += tot[t * K + c];
  s[threadIdx.x] = mine;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // Hillis-Steele, inclusive
    const T v = threadIdx.x >= off ? s[threadIdx.x - off] : T(0);
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
  T run = threadIdx.x ? s[threadIdx.x - 1] : T(0);
  for (long long t = t0; t < t1; ++t) {
    const T v = tot[t * K + c];
    tot[t * K + c] = run;
    run += v;
  }
}

template <typename T>
__global__ void scan_kernel(const T* __restrict__ x, T* __restrict__ out,
                            const T* __restrict__ carry, Layout L) {
  __shared__ T part[kThreads];
  const long long tile = blockIdx.x;
  const int tc = threadIdx.x % L.cw, rg = threadIdx.x / L.cw;
  long long r0, r1;
  group_rows(L, tile, rg, &r0, &r1);
  if (L.g == 1) {
    for (int c = tc; c < L.K; c += L.cw) {
      T run = carry[tile * L.K + c];
      for (long long r = r0; r < r1; ++r) {
        run += x[r * L.K + c];
        out[r * L.K + c] = run;
      }
    }
    return;
  }
  // cw == K: the row groups' sums, turned into exclusive offsets per column
  part[threadIdx.x] = sum_rows(x, r0, r1, L.K, tc);
  __syncthreads();
  if (rg == 0) {
    T run = carry[tile * L.K + tc];
    for (int j = 0; j < L.g; ++j) {
      const T v = part[j * L.cw + tc];
      part[j * L.cw + tc] = run;
      run += v;
    }
  }
  __syncthreads();
  T run = part[threadIdx.x];
#pragma unroll 8
  for (long long r = r0; r < r1; ++r) {
    run += x[r * L.K + tc];
    out[r * L.K + tc] = run;
  }
}

template <typename T>
int launch(const T* x, T* out, T* tot, long long S, int K, int R,
           cudaStream_t st) {
  Layout L;
  L.S = S;
  L.K = K;
  L.R = R;
  L.cw = K < kThreads ? K : kThreads;
  L.g = kThreads / L.cw;
  L.l = (R + L.g - 1) / L.g;
  const long long n_tiles = (S + R - 1) / R;
  const int threads = L.cw * L.g;
  tile_totals_kernel<T><<<static_cast<unsigned>(n_tiles), threads, 0, st>>>(
      x, tot, L);
  carry_kernel<T><<<K, kThreads, 0, st>>>(tot, n_tiles, K);
  scan_kernel<T><<<static_cast<unsigned>(n_tiles), threads, 0, st>>>(
      x, out, tot, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). x and out are [S, K] row-major,
// scratch holds ceil(S / rows_per_tile) * K values; dtype 0 is int32, 1 is
// float32. Launches on `stream` and returns cudaGetLastError() as an int
// (0 on success).
extern "C" int lane_cumsum(const void* x, void* out, void* scratch,
                           long long S, int K, int rows_per_tile, int dtype,
                           void* stream) {
  if (S <= 0 || K <= 0) return 0;
  if (rows_per_tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const int*>(x), static_cast<int*>(out),
                  static_cast<int*>(scratch), S, K, rows_per_tile, st);
  if (dtype == 1)
    return launch(static_cast<const float*>(x), static_cast<float*>(out),
                  static_cast<float*>(scratch), S, K, rows_per_tile, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
