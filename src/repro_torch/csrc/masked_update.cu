// masked_update — the replica update that closes every exchange, fused with
// the gather that feeds it.
//
// Replaces: src/repro/engine/kernels.py::masked_update (body _update_kernel).
// The TPU kernel takes the gathered `incoming = glob[local2global]` as a
// [K, Vmax(, F)] input (runtime.py:251), padding K to 8 and Vmax to 2048.
// Here the gather happens inside the kernel, so that array never exists:
//
//   out[k,v,f] = !vmask[k,v]     ? identity
//              : replicated[k,v] ? glob[local2global[k,v], f]
//              :                   state[k,v,f]
//
// A pure select: the result is exact.
//
// Bound on this card: bytes (no arithmetic at all). Each output element is
// written once and each input read at most once, so it runs at the H100's
// 3.35 TB/s at best.
//
// The first design ran a thread per output element: a 64-bit division by
// F per element, the mask, flag, index and value loads one behind the
// other, the mask and index bytes read F times a slot, no vector width
// (2.2x its bound at F = 1, 3.9x at F = 32). This one works by slot:
//   * F = 1: a thread owns kRun consecutive slots, its masks, flags,
//     indices and states read as one 4-, 4-, 16- and 16-byte load where
//     the pointers allow, the output written as one 16-byte store; a
//     ragged tail (or unaligned views) slot by slot;
//   * F % 4 == 0 with 16-byte aligned rows: a group of G threads (a power
//     of two, up to 32, at most F / 4) owns a slot and walks its row as
//     float4, so a warp reads and writes 32 consecutive float4s;
//   * any other F (or rows not 16-byte aligned): a thread a slot, its row
//     walked as scalars.
// In every form the three per-slot loads (vmask, replicated,
// local2global) issue together, a private slot never reads glob and a
// replicated slot never reads its state row, and the index arithmetic is
// shifts and multiplies. No shared memory, no allocation: the wrapper
// hands in the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;  // slots a thread of the F = 1 kernel owns

__host__ __device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// One slot's value at F = 1.
__device__ __forceinline__ float pick(bool vm, bool rep, int g, float st,
                                      const float* __restrict__ glob,
                                      int n_vertices, float ident) {
  if (!vm) return ident;
  if (!rep) return st;
  return g >= 0 && g < n_vertices ? glob[g] : ident;
}

__global__ void __launch_bounds__(kThreads)
    masked_update_scalar(const float* __restrict__ state,
                         const float* __restrict__ glob,
                         const int* __restrict__ l2g,
                         const bool* __restrict__ vmask,
                         const bool* __restrict__ replicated,
                         float* __restrict__ out, long long n_slots,
                         int n_vertices, float ident, bool vec) {
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kRun;
  if (s0 >= n_slots) return;
  if (vec && s0 + kRun <= n_slots) {
    const uchar4 vm = *reinterpret_cast<const uchar4*>(vmask + s0);
    const uchar4 rp = *reinterpret_cast<const uchar4*>(replicated + s0);
    const int4 g = *reinterpret_cast<const int4*>(l2g + s0);
    // state only where some slot is private
    float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((vm.x && !rp.x) || (vm.y && !rp.y) || (vm.z && !rp.z) ||
        (vm.w && !rp.w))
      st = *reinterpret_cast<const float4*>(state + s0);
    *reinterpret_cast<float4*>(out + s0) = make_float4(
        pick(vm.x, rp.x, g.x, st.x, glob, n_vertices, ident),
        pick(vm.y, rp.y, g.y, st.y, glob, n_vertices, ident),
        pick(vm.z, rp.z, g.z, st.z, glob, n_vertices, ident),
        pick(vm.w, rp.w, g.w, st.w, glob, n_vertices, ident));
    return;
  }
  const int n = static_cast<int>(n_slots - s0 < kRun ? n_slots - s0 : kRun);
  for (int j = 0; j < n; ++j) {
    const long long s = s0 + j;
    const bool vm = vmask[s], rep = replicated[s];
    const int g = l2g[s];
    out[s] = pick(vm, rep, g, vm && !rep ? state[s] : 0.f, glob,
                  n_vertices, ident);
  }
}

// The row of slot `slot` to copy (state or glob), or null for the
// identity.
template <typename T>
__device__ __forceinline__ const T* row_of(
    long long slot, int width, const T* __restrict__ state,
    const T* __restrict__ glob, const int* __restrict__ l2g,
    const bool* __restrict__ vmask, const bool* __restrict__ replicated,
    int n_vertices) {
  const bool vm = vmask[slot], rep = replicated[slot];
  const int g = l2g[slot];
  if (!vm) return nullptr;
  if (!rep) return state + slot * width;
  return g >= 0 && g < n_vertices
             ? glob + static_cast<long long>(g) * width : nullptr;
}

// F % 4 == 0, rows 16-byte aligned: 2^log2g threads a slot, float4s.
__global__ void __launch_bounds__(kThreads)
    masked_update_rows4(const float4* __restrict__ state,
                        const float4* __restrict__ glob,
                        const int* __restrict__ l2g,
                        const bool* __restrict__ vmask,
                        const bool* __restrict__ replicated,
                        float4* __restrict__ out, long long n_slots, int v,
                        int n_vertices, float ident, int log2g) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long slot = tid >> log2g;
  if (slot >= n_slots) return;
  const float4* src = row_of(slot, v, state, glob, l2g, vmask, replicated,
                             n_vertices);
  float4* dst = out + slot * v;
  const float4 fill = make_float4(ident, ident, ident, ident);
  for (int j = static_cast<int>(tid & ((1 << log2g) - 1)); j < v;
       j += 1 << log2g)
    dst[j] = src != nullptr ? src[j] : fill;
}

// Any other F: a thread a slot, scalars.
__global__ void __launch_bounds__(kThreads)
    masked_update_rows(const float* __restrict__ state,
                       const float* __restrict__ glob,
                       const int* __restrict__ l2g,
                       const bool* __restrict__ vmask,
                       const bool* __restrict__ replicated,
                       float* __restrict__ out, long long n_slots, int F,
                       int n_vertices, float ident) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= n_slots) return;
  const float* src = row_of(slot, F, state, glob, l2g, vmask, replicated,
                            n_vertices);
  float* dst = out + slot * F;
  for (int f = 0; f < F; ++f) dst[f] = src != nullptr ? src[f] : ident;
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int masked_update_f32(const float* state, const float* glob,
                                 const int* l2g, const bool* vmask,
                                 const bool* replicated, float* out,
                                 long long n_slots, int F, int n_vertices,
                                 float ident, void* stream) {
  if (n_slots <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 1) {
    const bool vec = aligned(vmask, 4) && aligned(replicated, 4) &&
                     aligned(l2g, 16) && aligned(state, 16) &&
                     aligned(out, 16);
    masked_update_scalar<<<blocks_for((n_slots + kRun - 1) / kRun),
                           kThreads, 0, st>>>(
        state, glob, l2g, vmask, replicated, out, n_slots, n_vertices, ident,
        vec);
  } else if (F % 4 == 0 && aligned(state, 16) && aligned(glob, 16) &&
             aligned(out, 16)) {
    const int v = F / 4;
    int log2g = 0;
    while (log2g < 5 && (2 << log2g) <= v) ++log2g;
    masked_update_rows4<<<blocks_for(n_slots << log2g), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(state),
        reinterpret_cast<const float4*>(glob), l2g, vmask, replicated,
        reinterpret_cast<float4*>(out), n_slots, v, n_vertices, ident,
        log2g);
  } else {
    masked_update_rows<<<blocks_for(n_slots), kThreads, 0, st>>>(
        state, glob, l2g, vmask, replicated, out, n_slots, F, n_vertices,
        ident);
  }
  return static_cast<int>(cudaGetLastError());
}
