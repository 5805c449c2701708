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
//   x[k,s,:] = feats[k, clamp(edge_nbr[k,s]), :] * w[k,s(,:)] where
//              emask[k,s] && s < csr_fill[k], else the combine identity
//              (the product is formed only for live slots, with one
//              rounding: a dead slot's weight never rescues it and an
//              identity is never multiplied by 0);
//   agg[k,v] = combine of x[k, run_start[k,l]..l], l = last_slot[k,v];
//   then every live slot s in [csr_fill[k], e_max) whose target is in
//   [0, V) and vmask is weighted and combined into agg[k, edge_tgt[k,s]]
//   (the unsorted append region), and agg is the identity where !vmask.
//   The result is always [K, V, F].
// The runs, the live append slots and who reduces what come from the
// plan's SegmentLayout, and the long runs' chunks from its GspmmLayout
// (engine/kernels.py), both built once per plan in plain PyTorch; this
// kernel reads them, the features and the weights.
//
// Bound on this card: bytes. Each live half-edge reads its index, its
// weight and an F-wide feature row and does 2F flops (multiply, combine),
// far below the H100's 67 TFLOP/s float32 rate per byte moved. What a
// plain walk loses: reading a run's index, mask and weight slot by slot
// keeps one dependent row load in flight; one group per target waits on
// the longest run it shares a warp with; hub partials combined by float
// atomics change the order of an add from call to call; a memset and
// extra launches cost more than the work at narrow widths. Design:
//   * one launch; no atomic touches a value (an int arrival counter per
//     split unit is the only atomic); every target has one writer, so the
//     order of an `add` is fixed by the layout: two calls give the same
//     bits;
//   * a lane group of G lanes gathers a slot's row, each lane VEC floats
//     of it a pass (16-byte loads where F % 4 == 0 and the planes are
//     aligned), the rows of several slots (kBuffer floats a lane) loaded
//     before any is combined;
//   * a tile block stages its window's row indices (the mask folded in as
//     -1), its scalar weights and each slot's target (listed by the layout)
//     in shared memory, in 16-byte loads all issued at once, then
//     splits the window's slots
//     evenly over its groups, whatever the run lengths: a group walks its
//     slots in order, writes each run that starts and ends in them, and
//     leaves a run that crosses its end to be finished, after a barrier,
//     by the group that began it with the partials of the groups it
//     continues into, in slot order. A target with no run is written (the
//     identity, or its append slots) by a group of its tile;
//   * a run too long for a tile is a unit, cut into chunks of a block
//     each, longest unit first in the grid. A chunk stages its indices and
//     weights too, and the block combines it (groups stride the slots,
//     then shuffles within a warp and the warps in a fixed order); a
//     one-chunk unit writes its target, otherwise each
//     chunk writes a partial row and the last block to arrive combines
//     the partials in chunk order. It is found by an unsigned counter per
//     unit, counted with atomicInc, whose last arrival of a call wraps it
//     to 0: CUDA-graph replays start clean, and every call writes the
//     unit's target;
//   * a target's writer combines its live append slots, listed by the
//     layout in slot order, after its run.
// The op (min, add, max) is a template parameter, so 36 kernels are built
// (12 lane shapes); with the op a launch argument, 12 built in 31 s
// against 75 s, but the kernel took 2-10% longer on an H100 (PERF.md, PR
// 19's findings). Nothing is allocated here: the wrapper hands in the
// output and, where a unit has more than one chunk, the partial rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMin = 0, kAdd = 1, kMax = 2;  // op codes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;      // resident blocks an SM, see gspmm_kernel
constexpr int kMaxTargets = 2048;  // a tile's targets at most
constexpr int kBuffer = 16;        // floats a lane gathers at once
constexpr int kBatch = 8;          // partial rows read at once
constexpr long long kMaxSmem = 227 * 1024 - kMaxTargets * 4;
constexpr unsigned kFull = 0xffffffffu;

struct Gs {
  const float* feats;          // [K*V, F]
  const float* w;              // [K*E] or [K*E, F]
  const int* nbr;              // [K*E]
  const unsigned char* emask;  // [K*E] bool
  float* out;                  // [K*V, F]
  const int4* tiles;           // two per tile, see kernels.py SegmentLayout
  const int* words;            // [K*V] run offset | length << 16
  const int* slot_targets;     // [K*E] target of a staged run's slot, or -1
  const int4* chunks;          // two per unit chunk, see GspmmLayout
  const int* app_ptr;          // [K*V + 1] (or [1] with no append slots)
  const int* app_slots;        // by (target, slot)
  float* partials;             // [n_chunks, F] where a unit is split
  unsigned* counters;          // [n_units] arrivals, 0 between calls
  int n_tiles, n_chunks;
  int n_app;
  int E, V, F;
  bool per_feature;
  bool stage4;
};

template <int kOp>
__device__ __forceinline__ float identity() {
  return kOp == kMin ? INFINITY : (kOp == kMax ? -INFINITY : 0.0f);
}

template <int kOp>
__device__ __forceinline__ float combine(float a, float b) {
  return kOp == kMin ? fminf(a, b) : (kOp == kMax ? fmaxf(a, b) : a + b);
}

// The row a live slot of the partition whose first row is `base` gathers
// (the neighbour clamped into [0, V)), and that of any flat slot.
__device__ __forceinline__ int row_at(const Gs& a, long long base, int nbr) {
  return static_cast<int>(base + min(max(nbr, 0), a.V - 1));
}

__device__ __forceinline__ long long row_of(const Gs& a, long long slot) {
  return row_at(a, slot / a.E * a.V, __ldg(a.nbr + slot));
}

// VEC floats of a feature or weight row: what one lane holds of a slot in
// a pass. Lane `lane` of a group of G holds piece c = pass*G + lane,
// floats c*VEC onward, where c is below the row's F / VEC pieces.
template <int VEC>
struct Piece {
  float v[VEC];

  __device__ __forceinline__ void load(const float* p) {
    if constexpr (VEC == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = __ldg(p + e);
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) p[e] = v[e];
    }
  }
  // a store to the output, marked streaming: written once, read by the
  // next kernel
  __device__ __forceinline__ void stream(float* p) const {
    if constexpr (VEC == 4) {
      __stcs(reinterpret_cast<float4*>(p),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) __stcs(p + e, v[e]);
    }
  }
  template <int kOp>
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = identity<kOp>();
  }
  // v <- v (+) x * w, one rounding each
  template <int kOp>
  __device__ __forceinline__ void add(const Piece& x, const Piece& w) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = combine<kOp>(v[e], __fmul_rn(x.v[e], w.v[e]));
  }
  template <int kOp>
  __device__ __forceinline__ void add(const Piece& x, float w) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = combine<kOp>(v[e], __fmul_rn(x.v[e], w));
  }
  template <int kOp>
  __device__ __forceinline__ void add(const Piece& x) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = combine<kOp>(v[e], x.v[e]);
  }
};

// Slots whose rows a lane gathers at once (half as many with per-feature
// weights, whose pieces take the other half of the buffer).
template <int VEC>
__host__ __device__ constexpr int slots_at_once() {
  return kBuffer / VEC < 2 ? 2 : (kBuffer / VEC > 8 ? 8 : kBuffer / VEC);
}

// v <- v (+) flat slot s's weighted piece (appends: one slot at a time)
template <int kOp, int VEC>
__device__ __forceinline__ void add_slot(const Gs& a, Piece<VEC>& v,
                                         long long s, int c) {
  Piece<VEC> x;
  x.load(a.feats + row_of(a, s) * a.F + c * VEC);
  if (a.per_feature) {
    Piece<VEC> w;
    w.load(a.w + s * a.F + c * VEC);
    v.template add<kOp>(x, w);
  } else {
    v.template add<kOp>(x, __ldg(a.w + s));
  }
}

// Target t's piece c: v combined with its live append slots in slot order
// (where `app`: its tile or unit may have some), then written.
template <int kOp, int VEC>
__device__ __forceinline__ void finish(const Gs& a, int t, Piece<VEC>& v,
                                       int c, bool app) {
  if (app) {
    const int end = __ldg(a.app_ptr + t + 1);
    for (int i = __ldg(a.app_ptr + t); i < end; ++i)
      add_slot<kOp>(a, v, __ldg(a.app_slots + i), c);
  }
  v.stream(a.out + static_cast<long long>(t) * a.F + c * VEC);
}

// Shared memory of a block for windows and chunks of up to `cap` slots:
// rows [wp] int, weights [wp] float and targets [wp] short (wp: cap
// rounded up to 16), then a tile's heads [nG * G * VEC] float and their
// targets [nG] int, or a unit's warp pieces [kWarps * G * VEC] float.
__host__ __device__ __forceinline__ long long window_slots(int cap) {
  return (static_cast<long long>(cap) + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ long long smem_bytes(int cap, int G,
                                                         int VEC) {
  const long long nG = kThreads / G, kW = static_cast<long long>(G) * VEC;
  const long long head = 4 * nG * kW + 4 * nG, red = 4LL * kWarps * kW;
  return window_slots(cap) * (4 + 4 + 2) + (head > red ? head : red);
}

// The block's combine of the `len` staged slots at rows / wts (flat slot
// s0 onward) for piece c: each group strides the slots, several rows
// gathered at once, then the groups of a warp combine by shuffles and the
// warps in order through `red`. The result is in the lanes of the block's
// first group (threadIdx.x < G); every thread must call this.
template <int kOp, int G, int VEC>
__device__ Piece<VEC> block_combine(const Gs& a, const int* rows,
                                    const float* wts, long long s0, int len,
                                    int c, float* red) {
  using P = Piece<VEC>;
  constexpr int nG = kThreads / G, kW = G * VEC;
  constexpr int kN = slots_at_once<VEC>();
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const bool ok = c < a.F / VEC;
  P acc;
  acc.template reset<kOp>();
  if (a.per_feature) {
    constexpr int kM = kN / 2;
    for (int s = g; s < len; s += nG * kM) {
      int r[kM];
      P x[kM], w[kM];
#pragma unroll
      for (int q = 0; q < kM; ++q) {
        r[q] = ok && s + q * nG < len ? rows[s + q * nG] : -1;
        if (r[q] >= 0) {
          x[q].load(a.feats + static_cast<long long>(r[q]) * a.F + c * VEC);
          w[q].load(a.w + (s0 + s + q * nG) * a.F + c * VEC);
        }
      }
#pragma unroll
      for (int q = 0; q < kM; ++q)
        if (r[q] >= 0) acc.template add<kOp>(x[q], w[q]);
    }
  } else {
    for (int s = g; s < len; s += nG * kN) {
      int r[kN];
      P x[kN];
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        r[q] = ok && s + q * nG < len ? rows[s + q * nG] : -1;
        if (r[q] >= 0)
          x[q].load(a.feats + static_cast<long long>(r[q]) * a.F + c * VEC);
      }
#pragma unroll
      for (int q = 0; q < kN; ++q)
        if (r[q] >= 0) acc.template add<kOp>(x[q], wts[s + q * nG]);
    }
  }
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc.v[e] = combine<kOp>(acc.v[e], __shfl_xor_sync(kFull, acc.v[e], o));
  if ((threadIdx.x & 31) < G)
    acc.store(red + (threadIdx.x >> 5) * kW + lane * VEC);
  __syncthreads();
  if (threadIdx.x < G) {
    for (int w = 1; w < kWarps; ++w) {
      P x;
#pragma unroll
      for (int e = 0; e < VEC; ++e) x.v[e] = red[w * kW + lane * VEC + e];
      acc.template add<kOp>(x);
    }
  }
  __syncthreads();  // red is free again
  return acc;
}

// One unit chunk: its indices and weights are staged in shared memory and
// the block combines them. A one-chunk unit writes its target; otherwise
// the chunk's partial row goes to `partials`, and the last chunk of the
// unit to arrive combines the unit's partial rows in chunk order.
template <int kOp, int G, int VEC>
__device__ void unit_block(const Gs& a, int b, unsigned char* dyn, int cap) {
  using P = Piece<VEC>;
  __shared__ bool last;
  const long long wp = window_slots(cap);
  int* rows = reinterpret_cast<int*>(dyn);
  float* wts = reinterpret_cast<float*>(rows + wp);
  float* red = wts + wp + wp / 2;  // past the targets
  const int4 c0 = __ldg(a.chunks + 2 * b);
  const int4 c1 = __ldg(a.chunks + 2 * b + 1);
  const int t = c0.x, len = c0.z, unit = c0.w, first = c1.x, n = c1.y;
  const long long s0 = c0.y;
  const long long base = s0 / a.E * a.V;  // the partition's first row
  const int lane = threadIdx.x % G;
  const int n_pieces = a.F / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const bool live = __ldg(a.emask + s0 + i) != 0;
    const int r = row_at(a, base, __ldg(a.nbr + s0 + i));
    wts[i] = a.per_feature ? 0.0f : __ldg(a.w + s0 + i);
    rows[i] = live ? r : -1;
  }
  __syncthreads();
  for (int c = lane; c - lane < n_pieces; c += G) {
    P acc = block_combine<kOp, G, VEC>(a, rows, wts, s0, len, c, red);
    if (threadIdx.x < G && c < n_pieces) {
      if (n == 1) {
        finish<kOp>(a, t, acc, c, a.n_app);
      } else {
        acc.store(a.partials + static_cast<long long>(b) * a.F + c * VEC);
      }
    }
  }
  if (n == 1) return;
  __threadfence();  // this chunk's partial row before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {  // counts 0 .. n - 1; the last arrival wraps it
    const unsigned top = n - 1;  // to 0 for the next call
    last = atomicInc(a.counters + unit, top) == top;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int f = threadIdx.x; f < a.F; f += kThreads) {
    const float* p = a.partials + static_cast<long long>(first) * a.F + f;
    float v = identity<kOp>();
    for (int c = 0; c < n; c += kBatch) {  // kBatch loads in flight
      float x[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        x[i] = c + i < n ? __ldcg(p + static_cast<long long>(c + i) * a.F)
                         : identity<kOp>();
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (c + i < n) v = c + i == 0 ? x[i] : combine<kOp>(v, x[i]);
    }
    if (a.n_app) {
      const int end = __ldg(a.app_ptr + t + 1);
      for (int i = __ldg(a.app_ptr + t); i < end; ++i) {
        const long long s = __ldg(a.app_slots + i);
        const float w = a.per_feature ? __ldg(a.w + s * a.F + f)
                                      : __ldg(a.w + s);
        v = combine<kOp>(v, __fmul_rn(__ldg(a.feats + row_of(a, s) * a.F + f),
                                      w));
      }
    }
    __stcs(a.out + static_cast<long long>(t) * a.F + f, v);
  }
}

// One group's walk of its window slots [lo, hi) for piece c: the run of
// each target that starts and ends there is finished; the run of `first`
// that began in an earlier group leaves its partial in `head`; the run
// that goes on past hi is returned pending (its target, or -1).
template <int kOp, int G, int VEC, bool kPerFeature>
__device__ __forceinline__ int walk(const Gs& a, const int* rows,
                                    const float* wts, const short* tgt,
                                    float* head, int* head_t, long long s0,
                                    int t0, int lo, int hi, int w, int c,
                                    bool app, Piece<VEC>& acc) {
  using P = Piece<VEC>;
  constexpr int kM = slots_at_once<VEC>() / (kPerFeature ? 2 : 1);
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const int first = lo < hi ? tgt[lo] : -1;
  const bool cont = first >= 0 && lo > 0 && tgt[lo - 1] == first;
  const bool ok = c < a.F / VEC;
  int cur = -1;
  auto leave = [&]() {
    if (cur < 0) return;
    if (cur == first && cont) {
      acc.store(head + (g * G + lane) * VEC);
      if (lane == 0) head_t[g] = cur;
    } else if (ok) {
      finish<kOp>(a, t0 + cur, acc, c, app);
    }
  };
  for (int s = lo; s < hi; s += kM) {
    int t[kM], r[kM];
    P x[kM], wv[kPerFeature ? kM : 1];
#pragma unroll
    for (int q = 0; q < kM; ++q) {
      t[q] = s + q < hi ? tgt[s + q] : -2;
      r[q] = ok && t[q] >= 0 ? rows[s + q] : -1;
      if (r[q] >= 0) {
        x[q].load(a.feats + static_cast<long long>(r[q]) * a.F + c * VEC);
        if constexpr (kPerFeature)
          wv[q].load(a.w + (s0 + s + q) * a.F + c * VEC);
      }
    }
#pragma unroll
    for (int q = 0; q < kM; ++q) {
      if (t[q] == -2) break;
      if (t[q] != cur) {
        leave();
        cur = t[q];
        acc.template reset<kOp>();
      }
      if (r[q] >= 0) {
        if constexpr (kPerFeature) {
          acc.template add<kOp>(x[q], wv[q]);
        } else {
          acc.template add<kOp>(x[q], wts[s + q]);
        }
      }
    }
  }
  if (cur >= 0 && !(cur == first && cont) && hi < w && tgt[hi] == cur)
    return cur;  // the run goes on into the next group
  leave();
  return -1;
}

// A slot's target in the tile of targets [t0, t0 + n), or -1 (no staged
// run's slot, or a neighbour tile's: a window starts at a multiple of 16
// slots of its partition, so its ends may reach into its neighbours').
__device__ __forceinline__ short local(int t, int t0, int n) {
  return static_cast<short>(t >= t0 && t < t0 + n ? t - t0 : -1);
}

// One tile: stage the window (row index or -1, scalar weight, target or
// -1), write the targets without a run, then walk the window's slots,
// split evenly over the groups.
template <int kOp, int G, int VEC>
__device__ void tile_block(const Gs& a, int tile, unsigned char* dyn,
                           int cap) {
  using P = Piece<VEC>;
  constexpr int nG = kThreads / G, kW = G * VEC;
  __shared__ int words[kMaxTargets];
  const long long wp = window_slots(cap);
  int* rows = reinterpret_cast<int*>(dyn);
  float* wts = reinterpret_cast<float*>(rows + wp);
  short* tgt = reinterpret_cast<short*>(wts + wp);
  float* head = reinterpret_cast<float*>(tgt + wp);
  int* head_t = reinterpret_cast<int*>(head + nG * kW);

  const int4 d0 = __ldg(a.tiles + 2 * tile);
  const int4 d1 = __ldg(a.tiles + 2 * tile + 1);
  const int t0 = d0.x, n = d0.y, w = d0.w;
  const long long s0 = d0.z;
  const long long base = (s0 / a.E) * a.V;  // the partition's first row
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const int n_pieces = a.F / VEC;
  const bool app = d1.z < d1.w;

  for (int i = threadIdx.x; i < n; i += kThreads)
    words[i] = __ldg(a.words + t0 + i);
  int done = 0;
  if (a.stage4) {  // 4 slots a load: s0 is a multiple of 4 (see gspmm_f32)
    const int w4 = w >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < w4; i += kThreads) {
      const uchar4 m =
          __ldg(reinterpret_cast<const uchar4*>(a.emask + s0) + i);
      const int4 nb = __ldg(reinterpret_cast<const int4*>(a.nbr + s0) + i);
      const float4 x =
          a.per_feature
              ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
              : __ldg(reinterpret_cast<const float4*>(a.w + s0) + i);
      reinterpret_cast<int4*>(rows)[i] = make_int4(
          m.x ? row_at(a, base, nb.x) : -1, m.y ? row_at(a, base, nb.y) : -1,
          m.z ? row_at(a, base, nb.z) : -1, m.w ? row_at(a, base, nb.w) : -1);
      reinterpret_cast<float4*>(wts)[i] = x;
      const int4 t =
          __ldg(reinterpret_cast<const int4*>(a.slot_targets + s0) + i);
      reinterpret_cast<short4*>(tgt)[i] = make_short4(
          local(t.x, t0, n), local(t.y, t0, n), local(t.z, t0, n),
          local(t.w, t0, n));
    }
    done = w4 << 2;
  }
  for (int i = done + threadIdx.x; i < w; i += kThreads) {
    const bool live = __ldg(a.emask + s0 + i) != 0;
    rows[i] = live ? row_at(a, base, __ldg(a.nbr + s0 + i)) : -1;
    wts[i] = a.per_feature ? 0.0f : __ldg(a.w + s0 + i);
    tgt[i] = local(__ldg(a.slot_targets + s0 + i), t0, n);
  }
  __syncthreads();
  // targets without a run: the identity, combined with their appends
  for (int i = g; i < n; i += nG) {
    if ((words[i] >> 16) != 0) continue;
    for (int c = lane; c < n_pieces; c += G) {
      P acc;
      acc.template reset<kOp>();
      finish<kOp>(a, t0 + i, acc, c, app);
    }
  }
  __syncthreads();

  // the walk: group g takes slots [lo, hi), a pass a piece
  const int per = (w + nG - 1) / nG;
  const int lo = min(w, g * per), hi = min(w, lo + per);
  for (int c = lane; c - lane < n_pieces; c += G) {
    if (lane == 0) head_t[g] = -1;
    P acc;
    const int pend =
        a.per_feature
            ? walk<kOp, G, VEC, true>(a, rows, wts, tgt, head, head_t, s0,
                                      t0, lo, hi, w, c, app, acc)
            : walk<kOp, G, VEC, false>(a, rows, wts, tgt, head, head_t, s0,
                                       t0, lo, hi, w, c, app, acc);
    __syncthreads();
    if (pend >= 0 && c < n_pieces) {  // this group began the run: add the
      for (int h = g + 1; h < nG && head_t[h] == pend; ++h) {  // heads
        P x;
#pragma unroll
        for (int e = 0; e < VEC; ++e) x.v[e] = head[(h * G + lane) * VEC + e];
        acc.template add<kOp>(x);
      }
      finish<kOp>(a, t0 + pend, acc, c, app);
    }
    __syncthreads();  // head is reused by the next pass
  }
}

// The grid: the unit chunks, longest unit first, then the tiles. Three
// resident blocks an SM (80 registers a thread): four spilled and ran the
// per-feature case 17% slower on an H100, two, five and six were slower
// too (PERF.md, PR 19's findings).
template <int kOp, int G, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gspmm_kernel(const Gs a, int cap) {
  extern __shared__ float4 dyn[];
  int b = blockIdx.x;
  if (b < a.n_chunks) {
    unit_block<kOp, G, VEC>(a, b, reinterpret_cast<unsigned char*>(dyn),
                            cap);
    return;
  }
  b -= a.n_chunks;
  if (b < a.n_tiles)
    tile_block<kOp, G, VEC>(a, b, reinterpret_cast<unsigned char*>(dyn),
                            cap);
}

template <int kOp, int G, int VEC>
int launch(const Gs& a, int cap, cudaStream_t st) {
  const long long smem = smem_bytes(cap, G, VEC);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gspmm_kernel<kOp, G, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(a.n_chunks + a.n_tiles);
  gspmm_kernel<kOp, G, VEC>
      <<<grid, kThreads, static_cast<size_t>(smem), st>>>(a, cap);
  return static_cast<int>(cudaGetLastError());
}

// The lane shapes built: (G, VEC). engine/kernels.py::gspmm_mapping picks
// one from F; tools/probe_kernels.py times the others.
#define GSPMM_SHAPES(X)                                                    \
  X(1, 1) X(2, 1) X(4, 1) X(8, 1) X(16, 1) X(32, 1)                        \
  X(1, 4) X(2, 4) X(4, 4) X(8, 4) X(16, 4) X(32, 4)

template <int kOp>
int launch_shape(const Gs& a, int cap, int g, int vec, cudaStream_t st) {
#define GSPMM_CASE(G, VEC) \
  if (g == G && vec == VEC) return launch<kOp, G, VEC>(a, cap, st);
  GSPMM_SHAPES(GSPMM_CASE)
#undef GSPMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes). feats [K*V, F], w [K*E] or
// [K*E, F] float32, edge_nbr [K*E] int32, emask [K*E] bool, out [K*V, F]
// float32, then the plan's SegmentLayout arrays, GspmmLayout's chunks, the
// partial rows ([n_chunks, F] float32 where a unit has more than one
// chunk) and the counters, then counts; window_cap is the most slots a
// tile's window or a unit chunk holds. slot_targets [K*E] int32 is the
// layout's: each slot of a run a tile stages, the run's target, else -1.
// (lanes, vec) is one of GSPMM_SHAPES; vec = 4 needs F % 4 == 0 and
// 16-byte aligned feats, out, partials and per-feature w. stage4 = 1 needs
// E % 4 == 0, 16-byte aligned edge_nbr, scalar w and slot_targets and a
// 4-byte aligned emask: a window starts at a multiple of 16 slots of its
// partition, so at flat slot k*E + 16j, a multiple of 4 only where E is.
// Launches one kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success).
extern "C" int gspmm_f32(const void* feats, const void* w, const void* nbr,
                         const void* emask, void* out, const void* tiles,
                         const void* words, const void* slot_targets,
                         const void* chunks, const void* app_ptr,
                         const void* app_slots, void* partials,
                         void* counters, int n_tiles, int n_chunks,
                         int window_cap, int tile_targets, int n_app, int E,
                         int V, int F, int per_feature, int op, int lanes,
                         int vec, int stage4, void* stream) {
  if (n_tiles < 0 || n_chunks < 0 || window_cap < 0 ||
      window_cap > 0xffff || tile_targets < 0 ||
      tile_targets > kMaxTargets || n_app < 0 || E < 1 || V < 1 || F < 1 ||
      op < kMin || op > kMax || (vec == 4 && F % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Gs a;
  a.feats = static_cast<const float*>(feats);
  a.w = static_cast<const float*>(w);
  a.nbr = static_cast<const int*>(nbr);
  a.emask = static_cast<const unsigned char*>(emask);
  a.out = static_cast<float*>(out);
  a.tiles = static_cast<const int4*>(tiles);
  a.words = static_cast<const int*>(words);
  a.slot_targets = static_cast<const int*>(slot_targets);
  a.chunks = static_cast<const int4*>(chunks);
  a.app_ptr = static_cast<const int*>(app_ptr);
  a.app_slots = static_cast<const int*>(app_slots);
  a.partials = static_cast<float*>(partials);
  a.counters = static_cast<unsigned*>(counters);
  a.n_tiles = n_tiles;
  a.n_chunks = n_chunks;
  a.n_app = n_app;
  a.E = E;
  a.V = V;
  a.F = F;
  a.per_feature = per_feature != 0;
  a.stage4 = stage4 != 0;
  const long long grid = static_cast<long long>(n_chunks) + n_tiles;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == kMin) return launch_shape<kMin>(a, window_cap, lanes, vec, st);
  if (op == kMax) return launch_shape<kMax>(a, window_cap, lanes, vec, st);
  return launch_shape<kAdd>(a, window_cap, lanes, vec, st);
}
