// frontier_min — ETSCH aggregation: the masked min over the partition axis.
//
// Replaces: src/repro/kernels/frontier_min.py::frontier_min (body _kernel).
// The TPU kernel loads [K, 2048] state and member tiles, K padded to the 8
// sublanes, and reduces over the sublane axis. Here no padding is needed:
//
//   out[v] = min over k of state[k, v] where member[k, v]; +inf if none.
//
// Bound on this card: bytes. Each state element (4 bytes, or 2 in bf16)
// and member flag (1 byte) is read once and each output written once; one
// compare per element is far below the card's arithmetic rate.
// Design: one thread per vertex column walks the K rows; neighbouring
// threads read neighbouring addresses of a row, so each warp's loads are
// contiguous. The value kept is the input element itself (a bf16 is only
// widened to compare), so the result is exact, and NaN propagates as in
// jnp.min.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float inf_of(float) { return INFINITY; }
__device__ __forceinline__ __nv_bfloat16 inf_of(__nv_bfloat16) {
  return __float2bfloat16(INFINITY);
}

template <typename T>
__global__ void frontier_min_kernel(const T* __restrict__ state,
                                    const bool* __restrict__ member,
                                    T* __restrict__ out, int K, long long V) {
  const long long v =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= V) return;
  T best = inf_of(T());
  float bw = INFINITY;
  for (int k = 0; k < K; ++k) {
    const long long i = static_cast<long long>(k) * V + v;
    if (!member[i]) continue;
    const T x = state[i];
    const float xw = widen(x);
    if (xw < bw || xw != xw) {  // a NaN, once kept, is never replaced
      best = x;
      bw = xw;
    }
  }
  out[v] = best;
}

}  // namespace

// Plain C entry point (loaded with ctypes). state [K, V] and member [K, V]
// row-major, out [V]; dtype 0 is float32, 1 is bfloat16. Launches on
// `stream` and returns cudaGetLastError() as an int (0 on success).
extern "C" int frontier_min(const void* state, const bool* member, void* out,
                            int K, long long V, int dtype, void* stream) {
  if (V <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((V + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    frontier_min_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(state), member, static_cast<float*>(out),
        K, V);
  } else if (dtype == 1) {
    frontier_min_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(state), member,
        static_cast<__nv_bfloat16*>(out), K, V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
