// minplus_sweep — one undirected min-plus relaxation sweep (ETSCH's local
// phase, and the vertex-centric references' round).
//
// Replaces: src/repro/kernels/minplus_sweep.py::minplus_sweep (body _kernel).
// The TPU kernel avoids a scatter: for every [512 vertices] x [512 edges]
// tile it builds a one-hot compare of the tile's targets against the
// vertex ids and min-reduces over the edge axis, O(V·E) compares in all.
// Here every row pulls instead, over a layout of the edge list's
// half-edges grouped by target row (kernels/ops.py MinplusLayout, built
// once per edge list):
//
//   out[r] = min(dist[r], min over half-edges (r <- o, edge e) with
//                mask[e] of dist[o] + cost)
//
// Jacobi, as the reference (ref.minplus_relax, core/etsch.py
// min_relax_sweep): every candidate is read from the *input* dist, never
// from out, so one sweep moves a frontier one hop and the sweep counts equal
// the reference's. `dist[o] + cost` is the same float32 IEEE addition the
// reference does, and min is exact and order-free, so the result is
// bit-identical. The layout holds no edge whose endpoint is outside the
// state (the old scatter skipped those too), and no self-loop unless the
// cost is negative: a self-loop's candidate dist[r] + cost never lowers
// row r at cost >= 0, and ETSCH pads every partition with masked (0, 0)
// slots, which would make row k·V + 0 a hub.
//
// Bound on this card: bytes (the state read and written once, the mask,
// the endpoints of live edges). The old design (a copy launch, then one
// thread per edge scattering both directions with atomics) paid a second
// pass over the state and three dependent round trips per edge. Design:
//   * one launch, each output row written exactly once, no atomics;
//   * a tile block owns tile_rows consecutive rows of one group: it loads
//     the tile's dist in 16-byte loads first, pulls its short rows (a few
//     half-edges, up to kShort loads in flight) a thread each into shared
//     memory, then writes the whole tile in 16-byte stores, so a row no
//     edge reaches costs one copy;
//   * every longer row is its own work unit, which writes it (its tile
//     skips it): a warp per medium row, kWarps to a block; a block per
//     large row; a cluster of kCluster blocks on neighbouring SMs per hub
//     (the layout decides which rows are which), whose partial minima
//     rank 0 reads through distributed shared memory. A power-law graph
//     puts its rich rows side by side (dblp: up to 25 rows of more than
//     32 half-edges, 38k half-edges, in one 256-row tile), so a tile that
//     pulled them, or a thread that pulled 32 half-edges four at a time,
//     ran long after the rest;
//   * units come first in the grid, longest rows first, then the tiles; a
//     thread issues every load of a round (records, then mask bytes and
//     dist[o]) before it tests a mask.
// With `replicas` S, every unit and tile runs once per replica: S copies
// of every group (multi-source SSSP's [K, S, V] state) under one layout.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;     // blocks per hub
constexpr int kShort = 8;       // a short row's loads in flight at once
constexpr int kMaxTile = 2048;  // rows of a tile at most (shared memory)
constexpr int kTileVecs = kMaxTile / 4 / kThreads;  // float4s a thread holds
constexpr unsigned kFull = 0xffffffffu;

struct Sweep {
  const float* dist;
  float* out;
  const unsigned char* mask;  // bool
  const int2* half_edges;     // (other row, edge id), by target
  const int2* entries;        // (first half-edge, local row | degree <<
                              // local_bits)
  const int* tile_ptr;        // [2 * n_tiles + 1]
  const int4* rows;           // (row, first, end, 0): hubs, large, medium
  int n_hub, n_large, n_medium;
  long long group_rows;       // V: rows of one group
  int tiles_per_group;
  int n_tiles;
  int tile_rows;
  int local_bits;
  int replicas;
  float cost;
  int vec;
};

// The state index of layout row k·V + v in replica s is (k·S + s)·V + v:
// the layout row plus this offset.
__device__ __forceinline__ long long replica_offset(const Sweep& a,
                                                    long long k, int s) {
  return (k * (a.replicas - 1) + s) * a.group_rows;
}

__device__ __forceinline__ float lower(float cand, float d) {
  return cand < d ? cand : d;
}

// min(m, the live candidates of half-edges lo, lo + step, ... < hi), with
// kIn half-edges' loads in flight at once.
template <int kIn>
__device__ __forceinline__ float pull(const Sweep& a, long long off, int lo,
                                      int hi, int step, float m) {
  for (int j = lo; j < hi; j += kIn * step) {
    int other[kIn], id[kIn];
#pragma unroll
    for (int q = 0; q < kIn; ++q) {
      const int i = j + q * step;
      const int2 h = i < hi ? __ldg(a.half_edges + i) : make_int2(-1, 0);
      other[q] = h.x;
      id[q] = h.y;
    }
    bool live[kIn];
    float d[kIn];
#pragma unroll
    for (int q = 0; q < kIn; ++q) {
      live[q] = other[q] >= 0 && __ldg(a.mask + id[q]) != 0;
      d[q] = other[q] >= 0 ? __ldg(a.dist + off + other[q]) : INFINITY;
    }
#pragma unroll
    for (int q = 0; q < kIn; ++q) {
      const float c = d[q] + a.cost;
      if (live[q] && c < m) m = c;
    }
  }
  return m;
}

__device__ __forceinline__ float warp_min(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = lower(__shfl_xor_sync(kFull, m, o), m);
  return m;
}

// The block's min of m, in thread 0. `scratch` holds kWarps.
__device__ __forceinline__ float block_min(float m, float* scratch) {
  m = warp_min(m);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = m;
  __syncthreads();
  float r = INFINITY;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r = lower(scratch[w], r);
  return r;
}

// A hub: its half-edges split over the cluster's threads.
__device__ void hub_unit(const Sweep& a, int4 h, long long off) {
  __shared__ float scratch[kWarps];
  __shared__ float partial;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const float m = block_min(
      pull<4>(a, off, h.y + rank * kThreads + threadIdx.x, h.z,
              kCluster * kThreads, INFINITY),
      scratch);
  if (threadIdx.x == 0) partial = m;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float best = INFINITY;
    for (int q = 0; q < kCluster; ++q)
      best = lower(*cluster.map_shared_rank(&partial, q), best);
    a.out[off + h.x] = lower(best, a.dist[off + h.x]);
  }
  cluster.sync();  // every block's `partial` stays alive until it is read
}

// A large row: one block.
__device__ void large_unit(const Sweep& a, int4 h, long long off) {
  __shared__ float scratch[kWarps];
  const float m = block_min(
      pull<4>(a, off, h.y + threadIdx.x, h.z, kThreads, INFINITY), scratch);
  if (threadIdx.x == 0) a.out[off + h.x] = lower(m, a.dist[off + h.x]);
}

// Medium rows: one warp each, kWarps to a block.
__device__ void medium_unit(const Sweep& a, int i, int s) {
  if (i >= a.n_hub + a.n_large + a.n_medium) return;  // whole warps
  const int4 h = __ldg(a.rows + i);
  const long long off = replica_offset(a, h.x / a.group_rows, s);
  const int lane = threadIdx.x & 31;
  const float d = a.dist[off + h.x];
  const float m = warp_min(pull<4>(a, off, h.y + lane, h.z, 32, INFINITY));
  if (lane == 0) a.out[off + h.x] = lower(m, d);
}

// One tile of tile_rows rows of one group in one replica: its short rows,
// and the copy of every row no unit writes.
__device__ void tile_block(const Sweep& a, int unit) {
  __shared__ float cand[kMaxTile];
  __shared__ __align__(4) unsigned char skip[kMaxTile];
  const int s = unit / a.n_tiles, t = unit % a.n_tiles;
  const long long k = t / a.tiles_per_group;
  const long long row0 = static_cast<long long>(t % a.tiles_per_group) *
                         a.tile_rows;
  const int w = static_cast<int>(min(static_cast<long long>(a.tile_rows),
                                     a.group_rows - row0));
  const long long off = replica_offset(a, k, s);
  const long long base = off + k * a.group_rows + row0;
  const float* src = a.dist + base;
  float* dst = a.out + base;
  const int* tp = a.tile_ptr + 2 * t;
  const int first_entry = __ldg(tp), short_end = __ldg(tp + 1),
            end = __ldg(tp + 2);
  const int local_mask = (1 << a.local_bits) - 1;
  float4 held[kTileVecs];  // the tile's dist, loaded before anything waits
  if (a.vec == 4) {
#pragma unroll
    for (int q = 0; q < kTileVecs; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (i < w / 4) held[q] = __ldg(reinterpret_cast<const float4*>(src) + i);
    }
  }
  for (int i = threadIdx.x; i < w; i += kThreads) {
    cand[i] = INFINITY;
    skip[i] = 0;
  }
  __syncthreads();
  for (int e = first_entry + threadIdx.x; e < short_end; e += kThreads) {
    const int2 en = __ldg(a.entries + e);
    cand[en.y & local_mask] = pull<kShort>(
        a, off, en.x, en.x + (en.y >> a.local_bits), 1, INFINITY);
  }
  for (int e = short_end + threadIdx.x; e < end; e += kThreads)
    skip[__ldg(a.entries + e).y & local_mask] = 1;  // its unit writes it
  __syncthreads();
  if (a.vec == 4) {  // w % 4 == 0 and base 16-byte aligned
#pragma unroll
    for (int q = 0; q < kTileVecs; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (i >= w / 4) break;
      const float4 d = held[q];
      const int r = 4 * i;
      const float4 o = make_float4(lower(cand[r], d.x), lower(cand[r + 1], d.y),
                                   lower(cand[r + 2], d.z),
                                   lower(cand[r + 3], d.w));
      if (*reinterpret_cast<const unsigned*>(skip + r) == 0) {
        reinterpret_cast<float4*>(dst)[i] = o;
      } else {
        if (!skip[r]) dst[r] = o.x;
        if (!skip[r + 1]) dst[r + 1] = o.y;
        if (!skip[r + 2]) dst[r + 2] = o.z;
        if (!skip[r + 3]) dst[r + 3] = o.w;
      }
    }
  } else {
    for (int i = threadIdx.x; i < w; i += kThreads)
      if (!skip[i]) dst[i] = lower(cand[i], __ldg(src + i));
  }
}

// The grid, every section once per replica: hub clusters (kCluster blocks
// each), large-row blocks, medium-row blocks (kWarps rows each), then
// the tiles, rounded up to whole clusters. Eight blocks an SM (32
// registers, a few spilled): the pulls wait on memory, and on an H100
// this ran faster than four or six blocks an SM with no spills.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 8) sweep_kernel(const Sweep a) {
  long long b = blockIdx.x;
  const long long hubs = static_cast<long long>(a.n_hub) * a.replicas;
  if (b < hubs * kCluster) {
    const long long u = b / kCluster;
    const int4 h = __ldg(a.rows + u % a.n_hub);
    hub_unit(a, h, replica_offset(a, h.x / a.group_rows,
                                  static_cast<int>(u / a.n_hub)));
    return;
  }
  b -= hubs * kCluster;
  const long long large = static_cast<long long>(a.n_large) * a.replicas;
  if (b < large) {
    const int4 h = __ldg(a.rows + a.n_hub + b % a.n_large);
    large_unit(a, h, replica_offset(a, h.x / a.group_rows,
                                    static_cast<int>(b / a.n_large)));
    return;
  }
  b -= large;
  const long long medium = (a.n_medium + kWarps - 1) / kWarps;
  if (b < medium * a.replicas) {
    medium_unit(a, a.n_hub + a.n_large +
                       static_cast<int>(b % medium) * kWarps +
                       (threadIdx.x >> 5),
                static_cast<int>(b / medium));
    return;
  }
  b -= medium * a.replicas;
  if (b < static_cast<long long>(a.n_tiles) * a.replicas)
    tile_block(a, static_cast<int>(b));
}

}  // namespace

// Plain C entry point (loaded with ctypes). dist/out [replicas · groups ·
// group_rows] float32, mask [E] bool, and the layout's arrays (see
// kernels/ops.py MinplusLayout, whose local_bits split an entry's second
// word). vec is 4 when group_rows % 4 == 0 and dist and out are 16-byte
// aligned, else 1. Launches on `stream` and returns cudaGetLastError() as
// an int (0 on success).
extern "C" int minplus_sweep_f32(const void* dist, void* out,
                                 const void* mask, const void* half_edges,
                                 const void* entries, const void* tile_ptr,
                                 const void* rows, int n_hub, int n_large,
                                 int n_medium, long long group_rows,
                                 int groups, int tile_rows, int local_bits,
                                 int replicas, float cost, int vec,
                                 void* stream) {
  if (tile_rows <= 0 || tile_rows > kMaxTile || tile_rows % 4 != 0 ||
      local_bits < 1 || local_bits > 27 || tile_rows > (1 << local_bits) ||
      groups < 1 || replicas < 1 || n_hub < 0 || n_large < 0 ||
      n_medium < 0 || group_rows < 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && group_rows % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (group_rows == 0) return 0;
  Sweep a;
  a.dist = static_cast<const float*>(dist);
  a.out = static_cast<float*>(out);
  a.mask = static_cast<const unsigned char*>(mask);
  a.half_edges = static_cast<const int2*>(half_edges);
  a.entries = static_cast<const int2*>(entries);
  a.tile_ptr = static_cast<const int*>(tile_ptr);
  a.rows = static_cast<const int4*>(rows);
  a.n_hub = n_hub;
  a.n_large = n_large;
  a.n_medium = n_medium;
  a.group_rows = group_rows;
  a.tiles_per_group =
      static_cast<int>((group_rows + tile_rows - 1) / tile_rows);
  a.n_tiles = groups * a.tiles_per_group;
  a.tile_rows = tile_rows;
  a.local_bits = local_bits;
  a.replicas = replicas;
  a.cost = cost;
  a.vec = vec;
  const long long blocks =
      (static_cast<long long>(n_hub) * kCluster + n_large +
       (n_medium + kWarps - 1) / kWarps + a.n_tiles) * replicas;
  const long long grid = (blocks + kCluster - 1) / kCluster * kCluster;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sweep_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
