// selective_scan_bwd — the gradient of the Mamba-1 forward scan of
// selective_scan.cu, one call per SSM layer of a training step's backward:
//
//   h_t = a_t ⊙ h_{t-1} + (dt_t x_t) ⊗ B_t,   a_t = exp(-dt_t ⊙ A)
//   y_t = C_t · h_t + D ⊙ x_t
//
// Given dy (and dh_last, the gradient of the final state, or null for
// zero), with g_t = dL/dh_t = dy_t ⊗ C_t + a_{t+1} ⊙ g_{t+1}:
//
//   dC_t = Σ_d dy_t h_t           dB_t = Σ_d g_t (dt_t x_t)
//   dx_t = Σ_n g_t dt_t B_t + D dy_t
//   ddt_t = Σ_n g_t (x_t B_t − A a_t h_{t−1})
//   dA = −Σ_{b,t} g_t dt_t a_t h_{t−1}    dD = Σ_{b,t} dy_t x_t
//   dh0 = a_1 ⊙ g_1 (the first step's)
//
// x, dt, dy, dx, ddt [B, S, Di]; B_t, C_t, dB, dC [B, S, N]; A, dA [Di, N];
// D, dD [Di]; dh_last, dh0 [B, Di, N]; hc [B, ceil(S / kChunk), Di, N], the
// state at the start of every chunk as selective_scan.cu saved it; all
// float32, contiguous. dB, dC, dA and dD are accumulated with atomics and
// must be zero on entry; the others are written whole.
//
// Replaces: no TPU kernel. The reference trains through
// src/repro/models/ssm.py::_selective_scan_chunked, which JAX
// differentiates; its Pallas kernel (src/repro/kernels/selective_scan.py)
// is forward-only. The port runs the forward in its own kernel, so the
// backward is written here.
//
// Design (simple first): a thread owns kP = 4 states of one channel (L =
// N / 4 lanes a channel), a block 128 threads, kCh = 128 / L channels of
// one batch row. The chunks are walked from the last to the first. In a
// chunk the thread recomputes h forward from the saved chunk state with
// the forward's own arithmetic (ex2.approx of dt · A2, A2 = −A log2 e, and
// the same fmaf), so the recomputed states are the forward's bit for bit;
// the chunk's kChunk × kP states stay in registers (the loops are
// unrolled). Then it walks the chunk's steps backwards carrying a ⊙ g.
// dx and ddt sum over the channel's L lanes by shuffles; dB and dC over
// the block's channels by shuffles within a warp and shared memory across
// warps, then one atomicAdd per block, step and state; dA and dD stay in
// registers over the whole sequence and go out in one atomicAdd a thread.
//
// Bound on this card: at falcon-mamba-7b's training shape (B 2, S 512,
// Di 8192, N 16) the bytes that must move (x, dt, dy, B, C, the chunk
// states, and the seven gradients) are ~203 MB, 0.061 ms at 3.35 TB/s;
// the recompute's B·S·Di·N = 134 M exps take 0.032 ms at 16 a clock on
// each of 132 SMs at 1.98 GHz (the kernel issues them twice: in the
// recompute and again in the backward walk). So bytes bound it. This
// design runs well above that: B·Di·L threads (65,536 there), each a
// serial walk of S steps, fill a quarter of the card's warp slots.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;  // must equal selective_scan.cu's kChunk
constexpr int kP = 4;       // states a thread owns
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kP consecutive floats at p (one 16-byte load when `vec`), or zeros when
// !ok.
__device__ __forceinline__ void load4(float (&v)[kP], const float* p,
                                      bool vec, bool ok) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < kP; ++i) v[i] = 0.f;
  } else if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < kP; ++i) v[i] = p[i];
  }
}

// The sum of v over the L lanes of a channel (consecutive lanes of a warp).
template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// 2^x, as selective_scan.cu computes the decay.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_bwd_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ dskip,
        const float* __restrict__ hc, const float* __restrict__ dy,
        const float* __restrict__ dh_last, float* __restrict__ dx,
        float* __restrict__ ddt, float* __restrict__ dB,
        float* __restrict__ dC, float* __restrict__ dA,
        float* __restrict__ dD, float* __restrict__ dh0, int S, int Di) {
  constexpr int L = N / kP;
  constexpr int kCh = kThreads / L;  // channels per block
  __shared__ float red_b[kWarps][kChunk][N];
  __shared__ float red_c[kWarps][kChunk][N];

  const int blocks_per_row = (Di + kCh - 1) / kCh;
  const long long b = blockIdx.x / blocks_per_row;
  const int d0 = (blockIdx.x % blocks_per_row) * kCh;
  const int width = min(kCh, Di - d0);  // live channels of this block
  const int c = threadIdx.x / L, n0 = (threadIdx.x % L) * kP;
  const bool live = c < width;
  const long long d = d0 + min(c, width - 1);  // dead lanes mirror a live
                                               // one with zero inputs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (S + kChunk - 1) / kChunk;
  const long long row0 = b * S;
  const long long hidx = (b * Di + d) * N + n0;
  const bool vec_bc = aligned16(bm) && aligned16(cm);

  float av[kP], a2[kP], carry[kP], da[kP];
  load4(av, a + d * N + n0, aligned16(a), true);
  load4(carry, dh_last + hidx, aligned16(dh_last), dh_last != nullptr);
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    a2[i] = av[i] * -kLog2e;
    da[i] = 0.f;
  }
  const float dn = dskip[d];
  float dd = 0.f;

  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk;
    float h0c[kP], hs[kChunk][kP];
    load4(h0c, hc + ((b * chunks + ch) * Di + d) * N + n0, aligned16(hc),
          true);
    // recompute the chunk's states as the forward computed them
    {
      float h[kP];
#pragma unroll
      for (int i = 0; i < kP; ++i) h[i] = h0c[i];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const bool ok = t0 + t < S;
        const long long r = row0 + t0 + t;
        const float xv = ok && live ? x[r * Di + d] : 0.f;
        const float dtv = ok && live ? dt[r * Di + d] : 0.f;
        float bv[kP];
        load4(bv, bm + r * N + n0, vec_bc, ok);
        const float dxv = dtv * xv;
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          h[i] = fmaf(ex2(dtv * a2[i]), h[i], dxv * bv[i]);
          hs[t][i] = h[i];
        }
      }
    }
    // walk the chunk backwards
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      const bool ok = t0 + t < S;
      const long long r = row0 + t0 + t;
      const float xv = ok && live ? x[r * Di + d] : 0.f;
      const float dtv = ok && live ? dt[r * Di + d] : 0.f;
      const float dyv = ok && live ? dy[r * Di + d] : 0.f;
      float bv[kP], cv[kP], vb[kP], vc[kP];
      load4(bv, bm + r * N + n0, vec_bc, ok);
      load4(cv, cm + r * N + n0, vec_bc, ok);
      const float dxv = dtv * xv;
      float pdx = 0.f, pddt = 0.f;
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const float at = ex2(dtv * a2[i]);
        const float hp = t > 0 ? hs[t - 1][i] : h0c[i];
        const float g = fmaf(dyv, cv[i], carry[i]);
        pdx = fmaf(g, bv[i], pdx);
        pddt = fmaf(g, fmaf(xv, bv[i], -av[i] * at * hp), pddt);
        da[i] = fmaf(-g * dtv, at * hp, da[i]);
        vb[i] = g * dxv;
        vc[i] = dyv * hs[t][i];
        carry[i] = at * g;
      }
      pdx = lane_sum<L>(pdx);
      pddt = lane_sum<L>(pddt);
      dd = fmaf(dyv, xv, dd);
      if (live && ok && n0 == 0) {
        dx[r * Di + d] = fmaf(pdx, dtv, dn * dyv);
        ddt[r * Di + d] = pddt;
      }
      // dB and dC: sum over the warp's channels (lanes L apart) ...
#pragma unroll
      for (int o = L; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          vb[i] += __shfl_xor_sync(kFull, vb[i], o);
          vc[i] += __shfl_xor_sync(kFull, vc[i], o);
        }
      }
      if (lane < L) {
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          red_b[warp][t][n0 + i] = vb[i];
          red_c[warp][t][n0 + i] = vc[i];
        }
      }
    }
    __syncthreads();
    // ... then over the block's warps, one atomicAdd a block
    for (int k = threadIdx.x; k < kChunk * N; k += kThreads) {
      const int t = k / N, n = k % N;
      if (t0 + t < S) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb += red_b[w][t][n];
          sc += red_c[w][t][n];
        }
        atomicAdd(dB + (row0 + t0 + t) * N + n, sb);
        atomicAdd(dC + (row0 + t0 + t) * N + n, sc);
      }
    }
    __syncthreads();  // the next chunk overwrites red_b and red_c
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    dh0[hidx + i] = carry[i];
    atomicAdd(dA + d * N + n0 + i, da[i]);
  }
  if (n0 == 0) atomicAdd(dD + d, dd);
}

template <int N>
int launch(const float* x, const float* dt, const float* bm, const float* cm,
           const float* a, const float* dskip, const float* hc,
           const float* dy, const float* dh_last, float* dx, float* ddt,
           float* dB, float* dC, float* dA, float* dD, float* dh0, int B,
           int S, int Di, cudaStream_t st) {
  constexpr int kCh = kThreads / (N / kP);
  const long long blocks = static_cast<long long>(B) * ((Di + kCh - 1) / kCh);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  selective_scan_bwd_kernel<N>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, dt, bm, cm, a, dskip, hc, dy, dh_last, dx, ddt, dB, dC, dA, dD,
      dh0, S, Di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Steps between two chunk states the kernel reads (hc).
extern "C" long long selective_scan_bwd_chunk() { return kChunk; }

// Plain C entry point (loaded with ctypes). dh_last may be null (zero).
// N must be 4, 8, 16 or 32; dB, dC, dA and dD must be zeroed. Launches on
// `stream` and returns cudaGetLastError() as an int (0 on success).
extern "C" int selective_scan_bwd_f32(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* a, const void* dskip, const void* hc, const void* dy,
    const void* dh_last, void* dx, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, int B, int S, int Di, int N, void* stream) {
  if (B <= 0 || Di <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in[9] = {
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dskip),
      static_cast<const float*>(hc), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last)};
  float* out[7] = {static_cast<float*>(dx), static_cast<float*>(ddt),
                   static_cast<float*>(dB), static_cast<float*>(dC),
                   static_cast<float*>(dA), static_cast<float*>(dD),
                   static_cast<float*>(dh0)};
#define SCAN_BWD_ARGS                                                     \
  in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], out[0],  \
      out[1], out[2], out[3], out[4], out[5], out[6], B, S, Di, st
  switch (N) {
    case 4: return launch<4>(SCAN_BWD_ARGS);
    case 8: return launch<8>(SCAN_BWD_ARGS);
    case 16: return launch<16>(SCAN_BWD_ARGS);
    case 32: return launch<32>(SCAN_BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SCAN_BWD_ARGS
}
