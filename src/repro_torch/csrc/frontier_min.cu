// frontier_min — ETSCH aggregation: the masked min over the partition axis.
//
// Replaces: src/repro/kernels/frontier_min.py::frontier_min (body _kernel).
// The TPU kernel loads [K, 2048] state and member tiles, K padded to the 8
// sublanes, and reduces over the sublane axis. Here no padding is needed:
//
//   out[v] = min over k of state[k, v] where member[k, v]; +inf if none.
//
// Bound on this card: bytes. Each member flag (1 byte) is read once, each
// state element (4 bytes, or 2 in bf16) where a member needs it, and each
// output written once; one compare per element is far below the card's
// arithmetic rate. ETSCH's caller has just written the state, so at dblp's
// [16, 317,080] it is read from the 50 MB L2, and what bounds the kernel is
// how many loads it issues and how long each thread waits on them. The
// first design (a thread per vertex column, one mask byte and one
// dependent 4-byte state load per row, 16 in a chain) lost to torch.amin
// of a pre-masked state, which reads more bytes in fewer, wider loads.
//
// Design: each thread owns VEC consecutive vertex columns (4 in float32, 8
// in bfloat16: one 16-byte state load a row; the wrapper picks 1 when V or
// a pointer's alignment does not allow that). It loads the mask words of
// kMaskRows = 16 rows at once (VEC bytes each), then the state vectors of
// kRows = 8 rows at a time, each only where one of its VEC flags is set,
// then compares them, and writes its VEC results in one store, so a thread
// waits on three round trips where the first design waited on 32. Holding
// 16 rows of state at once is no faster in float32 and slower in bfloat16
// (119 registers a thread against 93, ptxas); loading every state row
// without the mask test reads 25% more bytes and is slower (both measured
// on an H100). The value kept is the input
// element itself (a bf16 is only widened to compare), so the result is
// exact; NaN propagates as in jnp.min, and a NaN, once kept, is never
// replaced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaskRows = 16;  // rows whose mask words are loaded at once
constexpr int kRows = 8;       // rows whose state loads are in flight at once

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float inf_of(float) { return INFINITY; }
__device__ __forceinline__ __nv_bfloat16 inf_of(__nv_bfloat16) {
  return __float2bfloat16(INFINITY);
}

// VEC mask bytes as one word (a flag is a byte, 0 or 1).
template <int VEC> struct MaskWord;
template <> struct MaskWord<1> { using type = uint8_t; };
template <> struct MaskWord<4> { using type = uint32_t; };
template <> struct MaskWord<8> { using type = unsigned long long; };

// VEC values of T (at most 16 bytes), loaded and stored as one vector.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(Vec<T, VEC>* dst, const T* src) {
  if constexpr (sizeof(T) * VEC == 16)
    *reinterpret_cast<uint4*>(dst) =
        __ldg(reinterpret_cast<const uint4*>(src));
  else
    *dst = *reinterpret_cast<const Vec<T, VEC>*>(src);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* dst, const Vec<T, VEC>& src) {
  if constexpr (sizeof(T) * VEC == 16)
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&src);
  else
    *reinterpret_cast<Vec<T, VEC>*>(dst) = src;
}

// best[i] = x[i] where flag i of m is set and x[i] is smaller, or a NaN
// while best[i] is not (a NaN, once kept, is never replaced). Two forms,
// the same result: per-element branches build the faster float32 kernel,
// selects the faster bfloat16 one (measured on an H100).
template <typename T, int VEC, typename M>
__device__ __forceinline__ void take_min(Vec<T, VEC>& best, float* bw,
                                         const Vec<T, VEC>& x, M m) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const bool flag = (m >> (8 * i)) & 0xff;
    const float xw = widen(x.v[i]);
    if constexpr (sizeof(T) == 4) {
      if (!flag) continue;
      if (xw < bw[i] || (xw != xw && bw[i] == bw[i])) {
        best.v[i] = x.v[i];
        bw[i] = xw;
      }
    } else {
      const bool take = flag && (xw < bw[i] || (xw != xw && bw[i] == bw[i]));
      best.v[i] = take ? x.v[i] : best.v[i];
      bw[i] = take ? xw : bw[i];
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    frontier_min_kernel(const T* __restrict__ state,
                        const uint8_t* __restrict__ member,
                        T* __restrict__ out, int K, long long V) {
  using M = typename MaskWord<VEC>::type;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= V / VEC) return;
  const T* sp = state + g * VEC;
  const uint8_t* mp = member + g * VEC;
  Vec<T, VEC> best;
  float bw[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    best.v[i] = inf_of(T());
    bw[i] = INFINITY;
  }
  for (int k0 = 0; k0 < K; k0 += kMaskRows) {
    const int n = min(kMaskRows, K - k0);
    M m[kMaskRows];
#pragma unroll
    for (int j = 0; j < kMaskRows; ++j)
      m[j] = j < n ? __ldg(reinterpret_cast<const M*>(mp + j * V)) : M(0);
#pragma unroll
    for (int h = 0; h < kMaskRows; h += kRows) {
      Vec<T, VEC> x[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (m[h + j]) {
          load_vec(&x[j], sp + (h + j) * V);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[j].v[i] = inf_of(T());
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) take_min(best, bw, x[j], m[h + j]);
    }
    sp += kMaskRows * V;
    mp += kMaskRows * V;
  }
  store_vec(out + g * VEC, best);
}

template <typename T>
int launch(const void* state, const bool* member, void* out, int K,
           long long V, int vec, cudaStream_t st) {
  const long long groups = V / vec;
  const unsigned blocks =
      static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  const T* s = static_cast<const T*>(state);
  const uint8_t* m = reinterpret_cast<const uint8_t*>(member);
  T* o = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) {
      frontier_min_kernel<T, 8><<<blocks, kThreads, 0, st>>>(s, m, o, K, V);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (vec == 4)
    frontier_min_kernel<T, 4><<<blocks, kThreads, 0, st>>>(s, m, o, K, V);
  else
    frontier_min_kernel<T, 1><<<blocks, kThreads, 0, st>>>(s, m, o, K, V);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes). state [K, V] and member [K, V]
// row-major, out [V]; dtype 0 is float32, 1 is bfloat16; vec is the number
// of vertex columns a thread owns (1, 4, or 8 in bfloat16), chosen by the
// wrapper (repro_torch.kernels.ops.frontier_min_vec). A vec that does not
// divide V, loads more than 16 bytes of state, or that the pointers'
// alignment does not allow is refused. Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int frontier_min(const void* state, const bool* member, void* out,
                            int K, long long V, int dtype, int vec,
                            void* stream) {
  if (V <= 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int size = (dtype == 0 ? 4 : 2) * vec;  // state bytes a row
  if ((vec != 1 && vec != 4 && vec != 8) || size > 16 || V % vec != 0 ||
      !aligned(state, size) || !aligned(out, size) || !aligned(member, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(state, member, out, K, V, vec, st);
  return launch<__nv_bfloat16>(state, member, out, K, V, vec, st);
}
