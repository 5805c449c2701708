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
//              none);
//   then every live slot s in [csr_fill[k], e_max) is combined into
//   agg[k, edge_tgt[k,s]] (the unsorted append region), and agg is the
//   identity where !vmask.
// The runs, the live append slots and who reduces what come from the
// plan's SegmentLayout (engine/kernels.py), built once per plan in plain
// PyTorch; this kernel reads it and the messages.
//
// Bound on this card: bytes. Each live message is read once and combined
// once (one flop per 4-byte message), so the H100's 3.35 TB/s, not its
// arithmetic, limits it. The old design (a memset, a thread per target,
// hubs listed through a global atomic and strided by a fixed grid, the
// append region combined by atomics) paid four device operations and a
// scratch allocation per call, uncoalesced loads and a warp waiting on its
// longest run. Design:
//   * one launch, no atomics, nothing zeroed: every target has one writer;
//   * a tile block owns up to kMaxTargets consecutive targets of one
//     partition. It stages their slot window (16-slot aligned, at most a
//     few thousand slots) into shared memory in 16-byte loads, with the
//     identity already in masked slots, and its targets' layout words;
//     then a thread reduces each run of up to thread_max slots and a warp
//     each longer run of the tile, from shared memory, and every target is
//     written once (F contiguous), the identity where it has no run;
//   * a run too long for a tile is a unit of its own, skipped by its tile:
//     a block strides it. Units come first in the grid, longest first;
//   * a target's live append slots are listed by the layout, in slot
//     order, and its writer combines them after its run, so the order of
//     an `add` is fixed by the layout: two calls give the same bits.
// With window_cap * F floats over kStageBytes the tiles read the window
// from device memory instead of staging it (wide feature planes).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMin = 0, kAdd = 1, kMax = 2;  // op codes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;  // resident blocks an SM, see seg_kernel
constexpr int kMaxTargets = 2048;  // a tile's targets at most
constexpr int kUnitLen = 0x7FFF;   // a word's length: a unit's target
constexpr int kIn = 4;             // a unit thread's loads in flight
constexpr long long kStageBytes = 96 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Seg {
  const float* msgs;           // [K*E, F]
  const unsigned char* emask;  // [K*E] bool
  float* out;                  // [K*V, F]
  const int4* tiles;           // two per tile, see kernels.py SegmentLayout
  const int* words;            // [K*V] run offset | length << 16
  const int* warp_targets;     // by tile
  const int4* units;           // (target, first flat slot, length, 0)
  const int* app_ptr;          // [K*V + 1] (or [1] with no append slots)
  const int* app_slots;        // by (target, slot)
  int n_tiles, n_units;
  int thread_max;
  int n_app;
  int F;
  int vec;
};

template <int kOp>
__device__ __forceinline__ float identity() {
  return kOp == kMin ? INFINITY : (kOp == kMax ? -INFINITY : 0.0f);
}

template <int kOp>
__device__ __forceinline__ float combine(float a, float b) {
  return kOp == kMin ? fminf(a, b) : (kOp == kMax ? fmaxf(a, b) : a + b);
}

template <int kOp>
__device__ __forceinline__ float warp_reduce(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = combine<kOp>(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The block's reduction of x, in thread 0, in a fixed order. `scratch`
// holds kWarps and is free again when this returns.
template <int kOp>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
  x = warp_reduce<kOp>(x);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = identity<kOp>();
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r = combine<kOp>(r, scratch[w]);
  __syncthreads();
  return r;
}

// acc combined with target t's live append slots, in slot order.
template <int kOp>
__device__ __forceinline__ float appends(const Seg& a, int t, int f,
                                         float acc) {
  const int end = __ldg(a.app_ptr + t + 1);
  for (int j = __ldg(a.app_ptr + t); j < end; ++j)
    acc = combine<kOp>(
        acc, __ldg(a.msgs + static_cast<long long>(__ldg(a.app_slots + j)) *
                                a.F + f));
  return acc;
}

// acc combined with feature f of the live slots first, first + step, ...
// < len of the run at flat slot s0, kIn loads in flight at once.
template <int kOp>
__device__ __forceinline__ float pull(const Seg& a, long long s0, int len,
                                      int first, int step, int f,
                                      float acc) {
  for (int j = first; j < len; j += kIn * step) {
    bool live[kIn];
    float v[kIn];
#pragma unroll
    for (int q = 0; q < kIn; ++q) {
      const int i = j + q * step;
      live[q] = i < len && __ldg(a.emask + s0 + i) != 0;
      v[q] = i < len ? __ldg(a.msgs + (s0 + i) * a.F + f) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kIn; ++q)
      if (live[q]) acc = combine<kOp>(acc, v[q]);
  }
  return acc;
}

// A unit: one block strides its run.
template <int kOp>
__device__ void unit_block(const Seg& a, int4 u) {
  __shared__ float scratch[kWarps];
  for (int f = 0; f < a.F; ++f) {
    float r = block_reduce<kOp>(
        pull<kOp>(a, u.y, u.z, threadIdx.x, kThreads, f, identity<kOp>()),
        scratch);
    if (threadIdx.x == 0) {
      if (a.n_app) r = appends<kOp>(a, u.x, f, r);
      a.out[static_cast<long long>(u.x) * a.F + f] = r;
    }
  }
}

// The window's w slots at flat slot s0 into buf ([w, F] floats), the
// identity in masked slots; 16-byte loads where the wrapper allows them.
template <int kOp>
__device__ __forceinline__ void stage(const Seg& a, float* buf,
                                      long long s0, int w) {
  const int F = a.F;
  const int n = w * F;
  const float* src = a.msgs + s0 * F;
  const unsigned char* mask = a.emask + s0;
  const float ident = identity<kOp>();
  int done = 0;
  if (a.vec == 4) {
    const int n4 = n >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* buf4 = reinterpret_cast<float4*>(buf);
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 x = __ldg(src4 + i);
      bool m0, m1, m2, m3;
      if (F == 1) {
        const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(mask) + i);
        m0 = m.x, m1 = m.y, m2 = m.z, m3 = m.w;
      } else {
        const int e = 4 * i;
        m0 = __ldg(mask + e / F);
        m1 = __ldg(mask + (e + 1) / F);
        m2 = __ldg(mask + (e + 2) / F);
        m3 = __ldg(mask + (e + 3) / F);
      }
      x.x = m0 ? x.x : ident;
      x.y = m1 ? x.y : ident;
      x.z = m2 ? x.z : ident;
      x.w = m3 ? x.w : ident;
      buf4[i] = x;
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads)
    buf[i] = __ldg(mask + i / F) ? __ldg(src + i) : ident;
}

// Feature f of window slot s: from shared memory (identity already in
// masked slots) or, unstaged, from device memory.
template <int kOp, bool kStaged>
__device__ __forceinline__ float slot_value(const float* src,
                                            const unsigned char* mask, int s,
                                            int F, int f) {
  if (kStaged) return src[s * F + f];
  return __ldg(mask + s) ? __ldg(src + static_cast<long long>(s) * F + f)
                         : identity<kOp>();
}

// One tile: the runs of its targets up to thread_max slots by a thread
// each, the longer ones by a warp each, every target but its units'
// written once.
template <int kOp, bool kStaged>
__device__ void tile_block(const Seg& a, int tile, float* buf) {
  __shared__ int words[kMaxTargets];
  const int4 d0 = __ldg(a.tiles + 2 * tile);
  const int4 d1 = __ldg(a.tiles + 2 * tile + 1);
  const int t0 = d0.x, n = d0.y, w = d0.w;
  const long long s0 = d0.z;
  const int F = a.F;
  for (int i = threadIdx.x; i < n; i += kThreads)
    words[i] = __ldg(a.words + t0 + i);
  if (kStaged) stage<kOp>(a, buf, s0, w);
  __syncthreads();
  const float* src = kStaged ? buf : a.msgs + s0 * F;
  const unsigned char* mask = a.emask + s0;
  const bool app = d1.z < d1.w;
  float* out = a.out + static_cast<long long>(t0) * F;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int word = words[i];
    const int len = word >> 16, off = word & 0xffff;
    if (len > a.thread_max) continue;  // a warp's run, or a unit's
    for (int f = 0; f < F; ++f) {
      float acc = identity<kOp>();
      for (int s = off; s < off + len; ++s)
        acc = combine<kOp>(acc,
                           slot_value<kOp, kStaged>(src, mask, s, F, f));
      if (app) acc = appends<kOp>(a, t0 + i, f, acc);
      out[static_cast<long long>(i) * F + f] = acc;
    }
  }
  const int lane = threadIdx.x & 31;
  for (int j = d1.x + (threadIdx.x >> 5); j < d1.y; j += kWarps) {
    const int t = __ldg(a.warp_targets + j);
    const int word = words[t - t0];
    const int len = word >> 16, off = word & 0xffff;
    for (int f = 0; f < F; ++f) {
      float acc = identity<kOp>();
      for (int s = off + lane; s < off + len; s += 32)
        acc = combine<kOp>(acc,
                           slot_value<kOp, kStaged>(src, mask, s, F, f));
      acc = warp_reduce<kOp>(acc);
      if (lane == 0) {
        if (app) acc = appends<kOp>(a, t, f, acc);
        a.out[static_cast<long long>(t) * F + f] = acc;
      }
    }
  }
}

// The grid: the units, longest first, then the tiles. Six blocks an SM
// (40 registers) ran faster on an H100 than four, five or eight (32
// registers, more spills).
template <int kOp, bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    seg_kernel(const Seg a) {
  extern __shared__ float4 dyn[];
  int b = blockIdx.x;
  if (b < a.n_units) {
    unit_block<kOp>(a, __ldg(a.units + b));
    return;
  }
  b -= a.n_units;
  if (b < a.n_tiles)
    tile_block<kOp, kStaged>(a, b, reinterpret_cast<float*>(dyn));
}

template <int kOp, bool kStaged>
int launch(const Seg& a, unsigned grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        seg_kernel<kOp, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  seg_kernel<kOp, kStaged><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kOp>
int launch_op(const Seg& a, unsigned grid, bool staged, size_t smem,
              cudaStream_t st) {
  return staged ? launch<kOp, true>(a, grid, smem, st)
                : launch<kOp, false>(a, grid, 0, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes). msgs [K*E, F] float32, emask
// [K*E] bool, out [K*V, F] float32, then the plan's SegmentLayout arrays
// and counts (engine/kernels.py). vec is 4 when E*F % 4 == 0, msgs is
// 16-byte and emask 4-byte aligned (the tiles' windows start at a multiple
// of 16 slots), else 1. Launches one kernel on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int segment_reduce_f32(
    const void* msgs, const void* emask, void* out, const void* tiles,
    const void* words, const void* warp_targets, const void* units,
    const void* app_ptr, const void* app_slots, int n_tiles, int n_units,
    int window_cap, int tile_targets, int thread_max, int n_app, int F,
    int op, int vec, void* stream) {
  if (n_tiles < 0 || n_units < 0 || window_cap < 0 ||
      window_cap > 0xffff || tile_targets < 0 ||
      tile_targets > kMaxTargets || thread_max < 0 ||
      thread_max >= kUnitLen || n_app < 0 || F < 1 || op < kMin ||
      op > kMax || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Seg a;
  a.msgs = static_cast<const float*>(msgs);
  a.emask = static_cast<const unsigned char*>(emask);
  a.out = static_cast<float*>(out);
  a.tiles = static_cast<const int4*>(tiles);
  a.words = static_cast<const int*>(words);
  a.warp_targets = static_cast<const int*>(warp_targets);
  a.units = static_cast<const int4*>(units);
  a.app_ptr = static_cast<const int*>(app_ptr);
  a.app_slots = static_cast<const int*>(app_slots);
  a.n_tiles = n_tiles;
  a.n_units = n_units;
  a.thread_max = thread_max;
  a.n_app = n_app;
  a.F = F;
  a.vec = vec;
  const long long grid = static_cast<long long>(n_units) + n_tiles;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = static_cast<long long>(window_cap) * F * 4;
  const bool staged = bytes <= kStageBytes;
  const size_t smem = staged ? static_cast<size_t>(bytes + 15) / 16 * 16 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (op == kMin) return launch_op<kMin>(a, g, staged, smem, st);
  if (op == kMax) return launch_op<kMax>(a, g, staged, smem, st);
  return launch_op<kAdd>(a, g, staged, smem, st);
}
