// minplus_sweep — one undirected min-plus relaxation sweep (ETSCH's local
// phase, and the vertex-centric references' round).
//
// Replaces: src/repro/kernels/minplus_sweep.py::minplus_sweep (body _kernel).
// The TPU kernel avoids a scatter: for every [512 vertices] x [512 edges]
// tile it builds a one-hot compare of the tile's targets against the
// vertex ids and min-reduces over the edge axis, O(V·E) compares in all.
// Hopper has atomics, so the scatter-min is written as one:
//
//   out = dist;  for every edge e with mask[e], u = src[e], v = dst[e]:
//     out[v] = min(out[v], dist[u] + cost);  out[u] = min(out[u], dist[v] + cost)
//
// Jacobi, as the reference (ref.minplus_relax, core/etsch.py
// min_relax_sweep): every candidate is read from the *input* dist, never
// from out, so one sweep moves a frontier one hop and the sweep counts equal
// the reference's. `dist[u] + cost` is the same float32 IEEE addition the
// reference does, and min is exact, so the result is bit-identical.
//
// Bound on this card: bytes. dist is read and out written once (V floats
// each); each edge's src, dst (4 bytes each) and mask (1 byte) are read once.
// Design: a copy launch (out = dist), then one thread per edge doing both
// directions. A candidate that does not beat dist[target] is dropped
// without an atomic (exact: out only decreases from dist). Edges come in
// source order, so a hub's edges fill whole warps that all aim at the hub:
// lanes of a warp with the same target first take the min among themselves
// (__match_any_sync, then __reduce_min_sync on order-preserving integer
// images of the floats) and one lane per target issues the atomic. Float
// min uses the ordered-integer bit pattern trick (non-negative floats order
// as signed ints, negative ones reversed as unsigned ints), which keeps
// +-inf and negative values exact. An edge with an endpoint outside
// [0, V) is skipped.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void copy_kernel(const float* __restrict__ dist,
                            float* __restrict__ out, long long V) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < V) out[i] = dist[i];
}

// An int whose signed order is the float's order (non-NaN floats).
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// out[target] = min(out[target], cand) for every lane with target >= 0,
// lanes aiming at the same target combined first; every lane of the warp
// must call it.
__device__ __forceinline__ void warp_min_scatter(float* out, int target,
                                                 float cand) {
  const int lane = threadIdx.x & 31;
  const int key = target >= 0 ? target : -1 - lane;  // unique if none
  const unsigned group = __match_any_sync(0xffffffffu, key);
  const int best = __reduce_min_sync(group, ordered(cand));
  if (target >= 0 && lane == __ffs(group) - 1)
    atomic_min_f32(out + target, unordered(best));
}

// One thread per edge; no early return, since every lane takes part in the
// warp's combine (the grid's tail lanes carry no candidate).
__global__ void relax_kernel(const float* __restrict__ dist,
                             const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const bool* __restrict__ mask,
                             float* __restrict__ out, long long V,
                             long long E, float cost) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool live = e < E && mask[e];
  int u = 0, v = 0;
  if (live) {
    u = src[e];
    v = dst[e];
    live = u >= 0 && v >= 0 && u < V && v < V;
  }
  float du = INFINITY, dv = INFINITY;
  if (live) {
    du = dist[u];
    dv = dist[v];
  }
  const float to_v = du + cost;  // u -> v
  const float to_u = dv + cost;  // v -> u
  warp_min_scatter(out, live && to_v < dv ? v : -1, to_v);
  warp_min_scatter(out, live && to_u < du ? u : -1, to_u);
}

}  // namespace

// Plain C entry point (loaded with ctypes). dist/out [V] float32, src/dst
// [E] int32, mask [E] bool. Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int minplus_sweep_f32(const float* dist, const int* src,
                                 const int* dst, const bool* mask, float* out,
                                 long long V, long long E, float cost,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (V > 0) {
    copy_kernel<<<static_cast<unsigned>((V + threads - 1) / threads), threads,
                  0, st>>>(dist, out, V);
  }
  if (V > 0 && E > 0) {
    relax_kernel<<<static_cast<unsigned>((E + threads - 1) / threads),
                   threads, 0, st>>>(dist, src, dst, mask, out, V, E, cost);
  }
  return static_cast<int>(cudaGetLastError());
}
