// gspmm — gather neighbour feature rows, multiply by per-half-edge weights,
// combine per target, over a PartitionPlan's CSR stream (the GNN sweep,
// DGL's u_mul_e_{sum,max}).
//
// Replaces: src/repro/engine/kernels.py::_gspmm_scan (body _gspmm_kernel),
// wrapped there by gspmm. The TPU kernel pads K so that K*F fills 128
// lanes, transposes the weighted stream to [Emax, K*F] and runs a segmented
// scan down it; the caller reads each target at plan.last_slot. Here the
// target-sorted CSR is walked directly with F contiguous, as
// segment_reduce.cu does, and only each target's one value is formed.
//
// Semantics kept exactly (those of the scan):
//   x[k,s,:] = feats[k, edge_nbr[k,s], :] * w[k,s(,:)] where emask[k,s] &&
//              s < csr_fill[k], else the combine identity (the product is
//              formed only for live slots: a dead slot's weight never
//              rescues it and an identity is never multiplied by 0);
//   agg[k,v] = combine of x[k, run_start[k,l]..l], l = last_slot[k,v] and
//              run_start[k,l] the nearest s <= l with seg_start[k,s] (0 if
//              none; the wrapper hands it in, derived once per plan);
//   then every live slot s in [csr_fill[k], e_max) is weighted and combined
//   into agg[k, edge_tgt[k,s]] (the unsorted append region), and agg is the
//   identity where !vmask. The result is always [K, V, F].
//
// Bound on this card: bytes. Each live half-edge reads its index, its
// weight and an F-wide feature row and does 2F flops (multiply, combine),
// far below the H100's 67 TFLOP/s float32 rate per byte moved.
// Design: the lanes of a group run over F, so a gathered row is one
// coalesced read; G = F rounded up to a power of two, at most 32 (a warp),
// and a lane keeps up to kJ features of a pass in registers. One group per
// (k, v) target reduces its run alone. A run longer than kShort slots (a
// hub: dblp's largest has ~10^5 half-edges, 51 MB of rows at F=128) is
// instead cut into chunks of kChunk slots, listed, and its row set to the
// identity; a second launch gives each chunk a block, which reduces it in
// shared memory and combines its partial row into the target with atomics
// (atomicAdd, or the ordered-integer float max/min, which keeps +-inf). A
// third launch folds the append region in with the same atomics. Nothing
// is allocated here: the wrapper hands in the output and the scratch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMin = 0, kMax = 2;  // op codes; 1 is add

__device__ __forceinline__ float identity_of(int op) {
  return op == kMin ? INFINITY : (op == kMax ? -INFINITY : 0.0f);
}

__device__ __forceinline__ float combine(int op, float a, float b) {
  return op == kMin ? fminf(a, b) : (op == kMax ? fmaxf(a, b) : a + b);
}

// float min/max through integer atomics: non-negative floats order like
// signed ints, negative floats order reversed like unsigned ints.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_combine(int op, float* addr, float v) {
  if (op == kMin) {
    atomic_min_f32(addr, v);
  } else if (op == kMax) {
    atomic_max_f32(addr, v);
  } else {
    atomicAdd(addr, v);
  }
}

// Slots a group reduces alone before the target goes to the long-run
// kernel, and slots in one of that kernel's chunks. A listed run is over
// kShort slots, so it gives at most one chunk per kShort + 1 of its slots
// (kChunk >= kShort + 1): the chunk list never outgrows K * E / 32 entries.
constexpr int kShort = 32;
constexpr int kChunk = 256;
// Features a lane holds per pass (a pass covers G * kJ features).
constexpr int kJ = 4;
constexpr int kThreads = 256;
// The long-run kernel's grid, which strides over however many chunks were
// listed.
constexpr int kLongBlocks = 1024;

struct Plan {
  const float* feats;      // [K, V, F]
  const float* w;          // [K, E] or [K, E, F]
  const int* edge_nbr;     // [K, E]
  const bool* emask;       // [K, E]
  const int* run_start;    // [K, E]
  const int* last_slot;    // [K, V]
  const bool* vmask;       // [K, V]
  const int* edge_tgt;     // [K, E]
  const int* csr_fill;     // [K]
  int K, E, V, F;
  bool w_per_feature;
  int op;
};

// x[k, s, f] for a live slot s (row = k * E); the neighbour id is clamped
// into [0, V) so that no index reads outside the plane.
__device__ __forceinline__ float weighted(const Plan& p, long long row,
                                          int s, int f, const float* frow,
                                          float ws) {
  const float w = p.w_per_feature ? p.w[(row + s) * p.F + f] : ws;
  return __fmul_rn(frow[f], w);  // one rounding, as the plain version's
}

__device__ __forceinline__ const float* feature_row(const Plan& p, int k,
                                                    long long row, int s) {
  const int nbr = min(max(p.edge_nbr[row + s], 0), p.V - 1);
  return p.feats + (static_cast<long long>(k) * p.V + nbr) * p.F;
}

// One group of G lanes per (k, v) target: the run is reduced by the group
// alone, in slot order, unless it is longer than kShort slots, in which
// case the target's row is set to the identity and the run's chunks are
// listed in `work` (a count, then {target, first slot, last slot} each)
// for the long-run kernel.
template <int G>
__global__ void __launch_bounds__(kThreads) gspmm_short_kernel(Plan p,
                                                               float* out,
                                                               int* work) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long t = gid / G;
  const int lane = static_cast<int>(gid % G);
  if (t >= static_cast<long long>(p.K) * p.V) return;
  const int k = static_cast<int>(t / p.V);
  const long long row = static_cast<long long>(k) * p.E;
  // the run [start, hi] the target combines; empty (start > hi) for a
  // padding vertex or a run that starts in the identity region
  const int last = p.last_slot[t];
  const int hi = min(last, p.csr_fill[k] - 1);  // slots >= csr_fill: identity
  const int start = p.vmask[t] && hi >= 0 && last < p.E
                        ? p.run_start[row + last] : hi + 1;
  const bool listed = hi - start >= kShort;
  if (listed && lane == 0) {
    const int n = (hi - start + kChunk) / kChunk;
    int* chunk = work + 1 + 3LL * atomicAdd(work, n);
    for (int c = 0; c < n; ++c, chunk += 3) {
      chunk[0] = static_cast<int>(t);
      chunk[1] = start + c * kChunk;
      chunk[2] = min(start + (c + 1) * kChunk - 1, hi);
    }
  }
  const float ident = identity_of(p.op);
  for (int f0 = 0; f0 < p.F; f0 += G * kJ) {
    float acc[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[j] = ident;
    if (!listed) {
      for (int s = start; s <= hi; ++s) {
        if (!p.emask[row + s]) continue;
        const float* frow = feature_row(p, k, row, s);
        const float ws = p.w_per_feature ? 0.0f : p.w[row + s];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int f = f0 + lane + j * G;
          if (f < p.F) acc[j] = combine(p.op, acc[j],
                                        weighted(p, row, s, f, frow, ws));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int f = f0 + lane + j * G;
      if (f < p.F) out[t * p.F + f] = acc[j];
    }
  }
}

// One block per listed chunk at a time (a grid-stride loop over `work`):
// its groups stride through the chunk's slots, the block reduces their
// partial rows in shared memory (a tree, fixed order) and combines the
// result into the target with one atomic per feature, so a hub's chunks
// spread over the card.
template <int G>
__global__ void __launch_bounds__(kThreads) gspmm_long_kernel(
    Plan p, float* out, const int* work) {
  constexpr int nG = kThreads / G;
  __shared__ float red[kThreads * kJ];
  const int tid = threadIdx.x;
  const int g = tid / G;
  const int lane = tid % G;
  const int count = work[0];
  const float ident = identity_of(p.op);
  for (int c = blockIdx.x; c < count; c += gridDim.x) {
    const int* chunk = work + 1 + 3LL * c;
    const long long t = chunk[0];
    const int lo = chunk[1], hi = chunk[2];
    const int k = static_cast<int>(t / p.V);
    const long long row = static_cast<long long>(k) * p.E;
    for (int f0 = 0; f0 < p.F; f0 += G * kJ) {
      float acc[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[j] = ident;
      for (int s = lo + g; s <= hi; s += nG) {
        if (!p.emask[row + s]) continue;
        const float* frow = feature_row(p, k, row, s);
        const float ws = p.w_per_feature ? 0.0f : p.w[row + s];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int f = f0 + lane + j * G;
          if (f < p.F) acc[j] = combine(p.op, acc[j],
                                        weighted(p, row, s, f, frow, ws));
        }
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) red[(g * kJ + j) * G + lane] = acc[j];
      __syncthreads();
      for (int half = nG / 2; half > 0; half /= 2) {
        if (g < half) {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int a = (g * kJ + j) * G + lane;
            red[a] = combine(p.op, red[a], red[a + half * kJ * G]);
          }
        }
        __syncthreads();
      }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int f = f0 + lane + j * G;
          if (f < p.F) atomic_combine(p.op, out + t * p.F + f,
                                      red[j * G + lane]);
        }
      }
      __syncthreads();  // red is reused by the next pass or chunk
    }
  }
}

// One group of G lanes per (k, s) for s in [lo, E): live append-region
// slots of partition k (s >= csr_fill[k]) are weighted and combined into
// their target, the group's lanes striding over F.
template <int G>
__global__ void __launch_bounds__(kThreads) gspmm_append_kernel(Plan p,
                                                                float* out,
                                                                int lo) {
  const long long span = p.E - lo;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long ts = gid / G;
  const int lane = static_cast<int>(gid % G);
  if (ts >= static_cast<long long>(p.K) * span) return;
  const int k = static_cast<int>(ts / span);
  const int s = lo + static_cast<int>(ts % span);
  const long long row = static_cast<long long>(k) * p.E;
  if (s < p.csr_fill[k] || !p.emask[row + s]) return;
  const int v = p.edge_tgt[row + s];
  if (v < 0 || v >= p.V || !p.vmask[static_cast<long long>(k) * p.V + v]) {
    return;
  }
  const float* frow = feature_row(p, k, row, s);
  const float ws = p.w_per_feature ? 0.0f : p.w[row + s];
  float* dst = out + (static_cast<long long>(k) * p.V + v) * p.F;
  for (int f = lane; f < p.F; f += G) {
    atomic_combine(p.op, dst + f, weighted(p, row, s, f, frow, ws));
  }
}

template <int G>
cudaError_t launch_all(const Plan& p, float* out, int* work, int append_lo,
                       cudaStream_t st) {
  const long long lanes = static_cast<long long>(p.K) * p.V * G;
  gspmm_short_kernel<G><<<static_cast<unsigned>((lanes + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, st>>>(p, out, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gspmm_long_kernel<G><<<kLongBlocks, kThreads, 0, st>>>(p, out, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long append = static_cast<long long>(p.K) * (p.E - append_lo) * G;
  if (append > 0) {
    gspmm_append_kernel<G><<<static_cast<unsigned>((append + kThreads - 1) /
                                                   kThreads),
                             kThreads, 0, st>>>(p, out, append_lo);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). `work` is scratch the caller
// allocates: 1 + 3 * (K*E/32) ints (a count, then the long runs' chunks);
// `run_start` is the plan's per-slot run start. Launches the kernels on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int gspmm_f32(const float* feats, const float* w,
                         const int* edge_nbr, const bool* emask,
                         const int* run_start, const int* last_slot,
                         const bool* vmask, const int* edge_tgt,
                         const int* csr_fill, float* out, int* work, int K,
                         int E, int V, int F,
                         int w_per_feature, int append_lo, int op,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{feats, w, edge_nbr, emask, run_start, last_slot, vmask,
               edge_tgt, csr_fill, K, E, V, F, w_per_feature != 0, op};
  if (static_cast<long long>(K) * V == 0 || F == 0) return 0;
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // G: F rounded up to a power of two, at most a warp
  const int g = F > 16 ? 32 : (F > 8 ? 16 : (F > 4 ? 8 : (F > 2 ? 4 : F)));
  switch (g) {
    case 1: err = launch_all<1>(p, out, work, append_lo, st); break;
    case 2: err = launch_all<2>(p, out, work, append_lo, st); break;
    case 4: err = launch_all<4>(p, out, work, append_lo, st); break;
    case 8: err = launch_all<8>(p, out, work, append_lo, st); break;
    case 16: err = launch_all<16>(p, out, work, append_lo, st); break;
    default: err = launch_all<32>(p, out, work, append_lo, st); break;
  }
  return static_cast<int>(err);
}
