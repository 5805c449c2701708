// segment_reduce — per-target aggregates over a PartitionPlan's CSR stream.
//
// Replaces: src/repro/engine/kernels.py::segment_scan (body _seg_kernel),
// wrapped there by segment_reduce. The TPU kernel runs a segmented
// inclusive scan down an [Emax, K*F] transposed stream, lanes padded to 128,
// and the caller picks each target's value at plan.last_slot. Only that one
// value per target is ever read, so on Hopper this is a segmented *reduce*
// that walks the target-sorted CSR directly, F contiguous, no transpose.
//
// Semantics kept exactly (those of the scan):
//   m[k,s]   = messages[k,s,:] where emask[k,s] && s < csr_fill[k],
//              else the combine identity;
//   agg[k,v] = combine of m[k, run_start[k,l]..l], l = last_slot[k,v] and
//              run_start[k,l] the nearest s <= l with seg_start[k,s] (0 if
//              none; the wrapper hands it in, derived once per plan);
//   then every live slot s in [csr_fill[k], e_max) is combined into
//   agg[k, edge_tgt[k,s]] (the unsorted append region), and agg is the
//   identity where !vmask.
//
// Bound on this card: bytes. Each live message is read once and combined
// once (one flop per 4-byte message), so the H100's 3.35 TB/s, not its
// arithmetic, limits it.
// Design: one thread per (k, v) target reduces its CSR run alone
// (neighbouring threads own neighbouring runs, so their reads share cache
// lines). A run longer than 32 slots — a hub — is listed instead, and a
// second launch gives each listed run a whole block whose threads stride
// through it, so a hub of 10^5 half-edges does not leave one thread or one
// warp running long after the rest of the card is idle. A third launch
// folds the append region in with atomics. Float min/max atomics use the
// ordered-integer bit pattern trick (CUDA has no float atomicMin/Max),
// which keeps +-inf. Nothing is allocated here: the wrapper hands in the
// output and the list's scratch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMin = 0, kMax = 2;  // op codes; 1 is add
constexpr unsigned kFull = 0xffffffffu;

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

// Slots a thread reduces alone before the target goes to the long-run
// kernel.
constexpr int kShort = 32;
// The long-run kernel's threads per block.
constexpr int kThreads = 256;

// One thread per (k, v) target. Most targets own a short run of the CSR
// stream (the partition-local degree of a power-law graph is ~2), so a
// thread reduces the run alone, in slot order; neighbouring threads own
// neighbouring runs, so their reads share cache lines. A run longer than
// kShort slots (a hub; dblp's largest has ~10^5 edges) is listed in `work`
// for segment_long_kernel instead of serialising one thread or one warp.
__global__ void segment_short_kernel(
    const float* __restrict__ msgs, const bool* __restrict__ emask,
    const int* __restrict__ run_start, const int* __restrict__ last_slot,
    const bool* __restrict__ vmask, const int* __restrict__ csr_fill,
    float* __restrict__ out, int* __restrict__ work, int K, int E, int V,
    int F, int op) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(K) * V) return;
  const int k = static_cast<int>(t / V);
  const long long row = static_cast<long long>(k) * E;
  const int last = last_slot[t];
  const int hi = min(last, csr_fill[k] - 1);  // slots >= csr_fill: identity
  bool live = vmask[t] && hi >= 0 && last < E;
  const int start = live ? run_start[row + last] : 0;
  if (start > hi) live = false;  // the run starts in the identity region
  if (live && hi - start >= kShort) {  // a hub: the long-run kernel
    work[1 + atomicAdd(work, 1)] = static_cast<int>(t);
    return;
  }
  const float ident = identity_of(op);
  for (int f = 0; f < F; ++f) {
    float acc = ident;
    if (live) {
      for (int s = start; s <= hi; ++s) {
        if (emask[row + s]) acc = combine(op, acc, msgs[(row + s) * F + f]);
      }
    }
    out[t * F + f] = acc;
  }
}

// One block per listed long target at a time (a grid-stride loop over
// `work`). The block's threads stride through the run's slots, a shuffle
// tree and shared memory combine the threads, and thread 0 writes the
// target's value.
__global__ void __launch_bounds__(kThreads) segment_long_kernel(
    const float* __restrict__ msgs, const bool* __restrict__ emask,
    const int* __restrict__ run_start, const int* __restrict__ last_slot,
    const int* __restrict__ csr_fill, const int* __restrict__ work,
    float* __restrict__ out, int E, int V, int F, int op) {
  __shared__ float s_part[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float ident = identity_of(op);
  const int count = work[0];
  for (int item = blockIdx.x; item < count; item += gridDim.x) {
    const long long t = work[1 + item];
    const int k = static_cast<int>(t / V);
    const long long row = static_cast<long long>(k) * E;
    const int last = last_slot[t];
    const int hi = min(last, csr_fill[k] - 1);
    const int start = run_start[row + last];
    for (int f = 0; f < F; ++f) {
      float acc = ident;
      for (int s = start + tid; s <= hi; s += kThreads) {
        if (emask[row + s]) acc = combine(op, acc, msgs[(row + s) * F + f]);
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc = combine(op, acc, __shfl_xor_sync(kFull, acc, off));
      }
      if (lane == 0) s_part[tid / 32] = acc;
      __syncthreads();
      if (tid == 0) {
        float r = s_part[0];
        for (int w = 1; w < kThreads / 32; ++w) r = combine(op, r, s_part[w]);
        out[t * F + f] = r;
      }
      __syncthreads();  // s_part is reused by the next feature or item
    }
  }
}

// One thread per (k, s, f) for s in [lo, E): live append-region slots of
// partition k (s >= csr_fill[k]) are combined into their target.
__global__ void segment_append_kernel(
    const float* __restrict__ msgs, const bool* __restrict__ emask,
    const int* __restrict__ edge_tgt, const bool* __restrict__ vmask,
    const int* __restrict__ csr_fill, float* __restrict__ out, int K, int E,
    int V, int F, int lo, int op) {
  const long long span = E - lo;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(K) * span * F) return;
  const int f = static_cast<int>(i % F);
  const long long t = i / F;
  const int k = static_cast<int>(t / span);
  const int s = lo + static_cast<int>(t % span);
  const long long slot = static_cast<long long>(k) * E + s;
  if (s < csr_fill[k] || !emask[slot]) return;
  const int v = edge_tgt[slot];
  if (v < 0 || v >= V || !vmask[static_cast<long long>(k) * V + v]) return;
  float* dst = out + (static_cast<long long>(k) * V + v) * F + f;
  const float m = msgs[slot * F + f];
  if (op == kMin) {
    atomic_min_f32(dst, m);
  } else if (op == kMax) {
    atomic_max_f32(dst, m);
  } else {
    atomicAdd(dst, m);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `work` is scratch the caller
// allocates: 1 + K*V ints (a count, then the long targets); `run_start` is
// the plan's per-slot run start. Launches the three kernels on `stream` and returns cudaGetLastError() as an int (0 on
// success).
extern "C" int segment_reduce_f32(const float* msgs, const bool* emask,
                                  const int* run_start, const int* last_slot,
                                  const bool* vmask, const int* edge_tgt,
                                  const int* csr_fill, float* out, int* work,
                                  int K, int E, int V, int F, int append_lo,
                                  int op, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long targets = static_cast<long long>(K) * V;
  if (targets > 0) {
    cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (targets + kThreads - 1) / kThreads;
    segment_short_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        msgs, emask, run_start, last_slot, vmask, csr_fill, out, work, K, E,
        V, F, op);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // a fixed grid that loops over however many long targets were listed
    segment_long_kernel<<<512, kThreads, 0, st>>>(
        msgs, emask, run_start, last_slot, csr_fill, work, out, E, V, F, op);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_append = static_cast<long long>(K) * (E - append_lo) * F;
  if (n_append > 0) {
    const long long blocks = (n_append + kThreads - 1) / kThreads;
    segment_append_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        msgs, emask, edge_tgt, vmask, csr_fill, out, K, E, V, F, append_lo,
        op);
  }
  return static_cast<int>(cudaGetLastError());
}
