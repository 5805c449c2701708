// replica_exchange — the whole replica exchange of a superstep, one launch.
//
// Replaces: src/repro/engine/kernels.py::masked_update (body
// _update_kernel) together with the scatter that feeds it in the
// reference's runtime._exchange (runtime.py:224-256). There the live
// replicated slots are scattered into a global frontier glob [V(, F)] (XLA's
// scatter-min/add/max), glob is gathered back through local2global, and the
// TPU kernel picks, per slot, the identity (padding), the slot's own value
// (a private vertex) or the gathered one (a replicated vertex). On this card
// that chain was five device operations a superstep (a mask, a where, a
// fill of glob, an atomic scatter_reduce_ whose add order changes from call
// to call, the update). Here it is one:
//
//   out[k,v,:] = !vmask[k,v]      ? identity
//              : !replicated[k,v] ? values[k,v,:]
//              :  combine over the live replicated slots (k',v') with
//                 local2global[k',v'] == local2global[k,v], in ascending
//                 k', starting from the identity
//
// Bound on this card: bytes (one combine a replicated value, nothing
// else). Each live slot's value is read once, each replicated slot's index
// once, both masks once, every slot written once, so it runs at the H100's
// 3.35 TB/s at best. Design:
//   * no glob, no atomics, no scratch: a per-plan ExchangeLayout
//     (engine/kernels.py) lists each replicated vertex's live slots as a
//     group (flat slots k·Vmax + v, ascending k); the thread of a group
//     reads its slots' values, folds them in that order and writes the
//     result to every slot of the group. The order is fixed, so an add
//     gives the same bits from call to call;
//   * groups are listed by falling size: the threads of a warp hold groups
//     of one size (a hub in all 16 partitions beside hubs, a vertex with
//     two copies beside such vertices), and the largest start first. A
//     thread issues the index loads of up to four slots, then their value
//     loads, before it combines them (7% at F = 8; at F = 1 the scattered
//     4-byte accesses, a sector each, set the time, not their latency);
//   * the same launch copies private live slots and writes the identity to
//     padding, reading each slot's two mask bytes once; it skips replicated
//     live slots (their group writes them), so every element has one writer;
//   * F stays contiguous. At F = 1 a thread takes four slots: one 4-byte
//     load of each mask, one 16-byte load and store of values where no
//     slot of the four is replicated. At F = 8 a slot is two float4, and
//     two lanes share a group, one float4 each. No integer division: the
//     lanes of a group are a compile-time power of two;
//   * the op is a template parameter (a runtime op cost 2-10% in gspmm.cu).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMin = 0, kAdd = 1, kMax = 2;  // op codes
constexpr int kThreads = 256;
// widths: F = 1; F = 8 in float4; F % 4 == 0 in float4; any F by floats
constexpr int kF1 = 0, kF8 = 1, kVec4 = 2, kScalar = 3;

template <int kOp>
__device__ __forceinline__ float combine(float a, float b) {
  return kOp == kMin ? fminf(a, b) : (kOp == kMax ? fmaxf(a, b) : a + b);
}

template <int kOp>
__device__ __forceinline__ float4 combine(float4 a, float4 b) {
  return make_float4(combine<kOp>(a.x, b.x), combine<kOp>(a.y, b.y),
                     combine<kOp>(a.z, b.z), combine<kOp>(a.w, b.w));
}

template <int kOp>
__device__ __forceinline__ float identity() {
  return kOp == kMin ? INFINITY : (kOp == kMax ? -INFINITY : 0.0f);
}

template <typename V>
__device__ __forceinline__ V splat(float x);
template <>
__device__ __forceinline__ float splat<float>(float x) { return x; }
template <>
__device__ __forceinline__ float4 splat<float4>(float x) {
  return make_float4(x, x, x, x);
}

// One lane of a group: pieces lane, lane + kLanes, ... of V (float or
// float4) each, folded over the group's slots in layout order.
template <int kOp, typename V, int kLanes>
__device__ __forceinline__ void group_lane(const V* __restrict__ values,
                                           const int* __restrict__ slots,
                                           V* __restrict__ out, int lo,
                                           int hi, int lane, int pieces) {
  const V id = splat<V>(identity<kOp>());
  for (int p = lane; p < pieces; p += kLanes) {
    V acc = id;
    // up to four slots a batch: every index load, then every value load,
    // is issued before the first is used (a pair or a triple waits for
    // two loads, not for two a slot), then combined in layout order
    for (int j = lo; j < hi; j += 4) {
      const int n = hi - j;
      const long long s0 = slots[j];
      const long long s1 = n > 1 ? slots[j + 1] : 0;
      const long long s2 = n > 2 ? slots[j + 2] : 0;
      const long long s3 = n > 3 ? slots[j + 3] : 0;
      const V v0 = values[s0 * pieces + p];
      const V v1 = n > 1 ? values[s1 * pieces + p] : id;
      const V v2 = n > 2 ? values[s2 * pieces + p] : id;
      const V v3 = n > 3 ? values[s3 * pieces + p] : id;
      acc = combine<kOp>(acc, v0);
      if (n > 1) acc = combine<kOp>(acc, v1);
      if (n > 2) acc = combine<kOp>(acc, v2);
      if (n > 3) acc = combine<kOp>(acc, v3);
    }
    for (int j = lo; j < hi; ++j) {
      out[static_cast<long long>(slots[j]) * pieces + p] = acc;
    }
  }
}

// One slot's private copy or identity, in pieces of V; a replicated live
// slot is left to its group.
template <int kOp, typename V>
__device__ __forceinline__ void slot_copy(const V* __restrict__ values,
                                          const bool* __restrict__ vmask,
                                          const bool* __restrict__ replicated,
                                          V* __restrict__ out, long long s,
                                          int pieces) {
  if (!vmask[s]) {
    const V id = splat<V>(identity<kOp>());
    for (int p = 0; p < pieces; ++p) out[s * pieces + p] = id;
  } else if (!replicated[s]) {
    for (int p = 0; p < pieces; ++p) {
      out[s * pieces + p] = values[s * pieces + p];
    }
  }
}

// Four slots at F = 1 from one 4-byte load of each mask: a 16-byte load
// and store where none of the four is replicated and live, else a store
// per slot that is not.
template <int kOp>
__device__ __forceinline__ void slot_quad(const float* __restrict__ values,
                                          const bool* __restrict__ vmask,
                                          const bool* __restrict__ replicated,
                                          float* __restrict__ out,
                                          long long s0) {
  const uchar4 m = *reinterpret_cast<const uchar4*>(vmask + s0);
  const uchar4 r = *reinterpret_cast<const uchar4*>(replicated + s0);
  const float id = identity<kOp>();
  const bool private_any = (m.x && !r.x) || (m.y && !r.y) || (m.z && !r.z) ||
                           (m.w && !r.w);
  const float4 v = private_any
      ? *reinterpret_cast<const float4*>(values + s0)
      : make_float4(id, id, id, id);
  const float4 o = make_float4(m.x ? v.x : id, m.y ? v.y : id,
                               m.z ? v.z : id, m.w ? v.w : id);
  if (!((m.x && r.x) || (m.y && r.y) || (m.z && r.z) || (m.w && r.w))) {
    *reinterpret_cast<float4*>(out + s0) = o;
    return;
  }
  if (!(m.x && r.x)) out[s0] = o.x;
  if (!(m.y && r.y)) out[s0 + 1] = o.y;
  if (!(m.z && r.z)) out[s0 + 2] = o.z;
  if (!(m.w && r.w)) out[s0 + 3] = o.w;
}

// Blocks [0, group_blocks) run the groups, kLanes threads a group; the
// rest run the slots: four a thread at F = 1 with `quad`, else one.
template <int kOp, int kShape>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(const float* __restrict__ values,
                const bool* __restrict__ vmask,
                const bool* __restrict__ replicated,
                const int* __restrict__ ptr, const int* __restrict__ slots,
                float* __restrict__ out, int n_groups, int group_blocks,
                long long n_slots, int f, int quad) {
  constexpr int kLanes = kShape == kF8 ? 2 : 1;
  constexpr bool kWide = kShape == kF8 || kShape == kVec4;
  const int pieces = kShape == kF1 ? 1 : (kShape == kF8 ? 2
                                          : (kWide ? f / 4 : f));
  if (static_cast<int>(blockIdx.x) < group_blocks) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    const int g = t / kLanes;  // a power of two: a shift
    if (g >= n_groups) return;
    const int lo = ptr[g], hi = ptr[g + 1];
    if constexpr (kWide) {
      group_lane<kOp, float4, kLanes>(
          reinterpret_cast<const float4*>(values), slots,
          reinterpret_cast<float4*>(out), lo, hi, t % kLanes, pieces);
    } else {
      group_lane<kOp, float, kLanes>(values, slots, out, lo, hi, t % kLanes,
                                     pieces);
    }
    return;
  }
  const long long t =
      static_cast<long long>(blockIdx.x - group_blocks) * kThreads +
      threadIdx.x;
  if (kShape == kF1 && quad) {
    const long long s0 = 4 * t;
    if (s0 + 4 <= n_slots) {
      slot_quad<kOp>(values, vmask, replicated, out, s0);
    } else {
      for (long long s = s0; s < n_slots; ++s) {
        slot_copy<kOp, float>(values, vmask, replicated, out, s, 1);
      }
    }
    return;
  }
  if (t >= n_slots) return;
  if constexpr (kWide) {
    slot_copy<kOp, float4>(reinterpret_cast<const float4*>(values), vmask,
                           replicated, reinterpret_cast<float4*>(out), t,
                           pieces);
  } else {
    slot_copy<kOp, float>(values, vmask, replicated, out, t, pieces);
  }
}

template <int kOp, int kShape>
void launch(const float* values, const bool* vmask, const bool* replicated,
            const int* ptr, const int* slots, float* out, int n_groups,
            long long n_slots, int f, int quad, cudaStream_t stream) {
  constexpr int kLanes = kShape == kF8 ? 2 : 1;
  const long long group_blocks =
      (static_cast<long long>(n_groups) * kLanes + kThreads - 1) / kThreads;
  const long long slot_threads =
      kShape == kF1 && quad ? (n_slots + 3) / 4 : n_slots;
  const long long blocks =
      group_blocks + (slot_threads + kThreads - 1) / kThreads;
  if (blocks == 0) return;
  exchange_kernel<kOp, kShape><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      values, vmask, replicated, ptr, slots, out, n_groups,
      static_cast<int>(group_blocks), n_slots, f, quad);
}

template <int kOp>
void launch_shape(const float* values, const bool* vmask,
                  const bool* replicated, const int* ptr, const int* slots,
                  float* out, int n_groups, long long n_slots, int f, int vec,
                  cudaStream_t stream) {
  if (f == 1) {
    launch<kOp, kF1>(values, vmask, replicated, ptr, slots, out, n_groups,
                     n_slots, f, vec, stream);
  } else if (vec && f == 8) {
    launch<kOp, kF8>(values, vmask, replicated, ptr, slots, out, n_groups,
                     n_slots, f, 0, stream);
  } else if (vec && f % 4 == 0) {
    launch<kOp, kVec4>(values, vmask, replicated, ptr, slots, out, n_groups,
                       n_slots, f, 0, stream);
  } else {
    launch<kOp, kScalar>(values, vmask, replicated, ptr, slots, out,
                         n_groups, n_slots, f, 0, stream);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). values and out [n_slots, f]
// float32; vmask and replicated [n_slots] bool; the layout's ptr
// [n_groups + 1] and slots [ptr[n_groups]] int32; out allocated by the
// caller, 16-byte aligned. `vec` allows 16-byte accesses: values 16-byte
// aligned, the masks 4-byte aligned.
// Launches on `stream` and returns cudaGetLastError() as an int (0 on
// success).
extern "C" int replica_exchange_f32(const float* values, const bool* vmask,
                                    const bool* replicated, const int* ptr,
                                    const int* slots, float* out,
                                    int n_groups, int n_slots, int f, int op,
                                    int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f < 1 || n_slots < 0 || n_groups < 0) return cudaErrorInvalidValue;
  if (op == kMin) {
    launch_shape<kMin>(values, vmask, replicated, ptr, slots, out, n_groups,
                       n_slots, f, vec, s);
  } else if (op == kAdd) {
    launch_shape<kAdd>(values, vmask, replicated, ptr, slots, out, n_groups,
                       n_slots, f, vec, s);
  } else if (op == kMax) {
    launch_shape<kMax>(values, vmask, replicated, ptr, slots, out, n_groups,
                       n_slots, f, vec, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
