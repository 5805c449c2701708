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
// Bound on this card: bytes (no arithmetic at all). Each output element is
// written once and each input read at most once, so it runs at the H100's
// 3.35 TB/s at best.
// Design: one thread per output element, F contiguous, so consecutive
// threads read and write consecutive addresses; a private slot never
// touches glob and a replicated slot never touches state. No shared memory,
// no allocation: the wrapper hands in the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void masked_update_kernel(
    const float* __restrict__ state, const float* __restrict__ glob,
    const int* __restrict__ l2g, const bool* __restrict__ vmask,
    const bool* __restrict__ replicated, float* __restrict__ out,
    long long n_slots, int F, int n_vertices, float ident) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_slots * F) return;
  const long long kv = i / F;
  const int f = static_cast<int>(i - kv * F);
  float r = ident;
  if (vmask[kv]) {
    if (replicated[kv]) {
      const int g = l2g[kv];
      if (g >= 0 && g < n_vertices) r = glob[static_cast<long long>(g) * F + f];
    } else {
      r = state[i];
    }
  }
  out[i] = r;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int masked_update_f32(const float* state, const float* glob,
                                 const int* l2g, const bool* vmask,
                                 const bool* replicated, float* out,
                                 long long n_slots, int F, int n_vertices,
                                 float ident, void* stream) {
  const long long n = n_slots * F;
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    masked_update_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        state, glob, l2g, vmask, replicated, out, n_slots, F, n_vertices,
        ident);
  }
  return static_cast<int>(cudaGetLastError());
}
