// selective_scan — the Mamba-1 forward scan, one call per layer of prefill
// and of every decode step:
//
//   h_t = exp(-dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t
//   y_t = C_t · h_t + D ⊙ x_t
//
// x, dt, y [B, S, Di]; B_t, C_t [B, S, N]; A [Di, N]; D [Di]; h0, h_last
// [B, Di, N]; all float32, row-major and contiguous. h0 may be null (zero).
// hc, null in serving, receives the state at the start of every kChunk
// steps, [B, ceil(S / kChunk), Di, N]: what selective_scan_bwd.cu
// recomputes each chunk from in the backward.
//
// Replaces: src/repro/kernels/selective_scan.py::selective_scan (body
// _kernel). The TPU kernel tiles Di into 128-lane blocks, pads S to a
// chunk, and walks the chunks one after another on one core with the state
// [B, block_d, N] in VMEM scratch. Here the recurrence is independent per
// (b, d, n), so each state element lives in a register of one thread for
// the whole sequence, and nothing needs carrying between blocks.
//
// Bound on this card: the exps, then the bytes. At the prefill shape (B 4,
// S 512, Di 8192, N 16) x, dt and y move ~201 MB (0.060 ms at 3.35 TB/s),
// and the 268 M exps take 0.064 ms on the SFUs (16 a clock on each of 132
// SMs at 1.98 GHz); the other float32 work is ~1.6 GFLOP. The first design
// (a thread per state element) issued a precise expf, four shared loads
// and a 4-shuffle reduction per element and step: ~25-30 instructions,
// ~0.23 ms of issue alone. This one issues ~5:
//   * a thread owns P = N / L states of one channel (L = lanes_for(N)
//     lanes per channel: 1 up to N = 16, which measured fastest at N = 16,
//     and 16 states a thread beyond), so x_t and dt_t are read once per
//     channel, B_t and C_t are 16-byte broadcasts from shared memory, and
//     y_t sums in registers and then over L lanes (log2 L shuffles);
//   * exp(-dt·A) is ex2.approx(dt · A2) with A2 = -A·log2(e) premultiplied
//     once per state: one SFU instruction and one multiply per element and
//     step; C·h sums in four partial sums;
//   * chunks of kChunk steps are staged with cp.async into two buffers, so
//     the next chunk's loads run under the current chunk's compute; the
//     time loop over a chunk is unrolled. Steps past S are staged as
//     dt = x = 0, which leaves h exactly unchanged (exp2(0) = 1), so the
//     last chunk runs the same unrolled loop and only skips its y stores;
//   * decode (S = 1) has its own kernel with no staging: a thread owns 4
//     states, h0, A, B_t and C_t come in and h_last goes out in 16-byte
//     accesses where the pointers allow (a call that asks for the chunk
//     states runs the prefill kernel, at any S);
//   * with hc given, each thread stores its states before each chunk: one
//     [B, Di, N] write every kChunk steps, 1/16 of the x, dt, y traffic.
// The result stays within float32 rounding of the sequential plain
// version: ex2.approx is within 2 ulp (and flushes results below 2^-126),
// A2 adds one rounding to the exponent, and the two differ in the order of
// the N-term dot and in contracted multiply-adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // prefill block
constexpr int kChunk = 16;     // timesteps per staged chunk
constexpr int kStepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Lanes per channel of the prefill kernel for state width N: a thread
// holds at most 16 states.
__host__ __device__ constexpr int lanes_for(int N) {
  return N > 16 ? N / 16 : 1;
}

// 4 bytes from global to shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// P consecutive floats at p (16-byte loads when `vec`: p's base aligned
// and P % 4 == 0).
template <int P>
__device__ __forceinline__ void load_run(float (&v)[P], const float* p,
                                         bool vec) {
  if constexpr (P % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < P; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = p[i];
}

template <int P>
__device__ __forceinline__ void store_run(float* p, const float (&v)[P],
                                          bool vec) {
  if constexpr (P % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < P; i += 4)
        *reinterpret_cast<float4*>(p + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) p[i] = v[i];
}

// The sum of v over the L lanes of a channel (consecutive lanes of a warp).
template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// 2^x in one SFU instruction; a result below 2^-126 flushes to 0 (a
// decay that small leaves h at the inject term either way).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One step of P states: h = exp2(dt·A2) h + (dt x) B; returns C · h,
// summed in up to four partial sums so the dot is not one serial chain.
template <int P>
__device__ __forceinline__ float step(float (&h)[P], const float (&a2)[P],
                                      const float (&bv)[P],
                                      const float (&cv)[P], float dtv,
                                      float xv) {
  constexpr int kSums = P < 4 ? P : 4;
  const float dx = dtv * xv;
  float p[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) p[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    h[i] = fmaf(ex2(dtv * a2[i]), h[i], dx * bv[i]);
    p[i % kSums] = fmaf(h[i], cv[i], p[i % kSums]);
  }
#pragma unroll
  for (int w = kSums / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) p[i] += p[i + w];
  return p[0];
}

// Prefill: a block of kThreads holds kThreads / L channels of one batch
// row, P = N / L states per thread.
template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ dskip,
        const float* __restrict__ h0, float* __restrict__ y,
        float* __restrict__ h_last, float* __restrict__ hc, int S, int Di) {
  constexpr int L = lanes_for(N);
  constexpr int P = N / L;
  constexpr int kCh = kThreads / L;  // channels per block
  __shared__ float xs[2][kChunk][kCh];
  __shared__ float ds[2][kChunk][kCh];
  __shared__ __align__(16) float bs[2][kChunk][N];
  __shared__ __align__(16) float cs[2][kChunk][N];

  const int blocks_per_row = (Di + kCh - 1) / kCh;
  const long long b = blockIdx.x / blocks_per_row;
  const int d0 = (blockIdx.x % blocks_per_row) * kCh;
  const int width = min(kCh, Di - d0);  // live channels of this block
  const int c = threadIdx.x / L, n0 = (threadIdx.x % L) * P;
  const bool live = c < width;
  const long long d = d0 + min(c, width - 1);  // dead lanes mirror a live one
  const long long hidx = (b * Di + d) * N + n0;

  float a2[P], h[P];
  load_run(a2, a + d * N + n0, aligned16(a));
#pragma unroll
  for (int i = 0; i < P; ++i) {
    a2[i] *= -kLog2e;
    h[i] = 0.f;
  }
  if (h0 != nullptr) load_run(h, h0 + hidx, aligned16(h0));
  const float dn = dskip[d];

  const long long row0 = b * S;  // row (b, 0) of x, dt, y, B and C
  auto stage = [&](int buf, int t0) {
    for (int i = threadIdx.x; i < kChunk * kCh; i += kThreads) {
      const int t = i / kCh, j = i % kCh;
      const bool ok = t0 + t < S && j < width;
      const long long off = ok ? (row0 + t0 + t) * Di + d0 + j : 0;
      cp_async4(&xs[buf][t][j], x + off, ok);
      cp_async4(&ds[buf][t][j], dt + off, ok);
    }
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int t = i / N, j = i % N;
      const bool ok = t0 + t < S;
      const long long off = ok ? (row0 + t0 + t) * N + j : 0;
      cp_async4(&bs[buf][t][j], bm + off, ok);
      cp_async4(&cs[buf][t][j], cm + off, ok);
    }
    cp_async_commit();
  };

  const int chunks = (S + kChunk - 1) / kChunk;
  if (chunks > 0) stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1, t0 = ch * kChunk;
    if (hc != nullptr && live)
      store_run(hc + ((b * chunks + ch) * Di + d) * N + n0, h,
                aligned16(hc));
    if (ch + 1 < chunks) {
      stage(buf ^ 1, t0 + kChunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      float bv[P], cv[P];
      load_run(bv, &bs[buf][t][n0], true);
      load_run(cv, &cs[buf][t][n0], true);
      const float xv = xs[buf][t][c];
      const float p =
          lane_sum<L>(step(h, a2, bv, cv, ds[buf][t][c], xv));
      if (live && n0 == 0 && t0 + t < S)
        y[(row0 + t0 + t) * Di + d] = fmaf(xv, dn, p);
    }
    __syncthreads();  // the next stage overwrites this buffer
  }
  if (live) store_run(h_last + hidx, h, aligned16(h_last));
}

// Decode (S = 1): a thread owns 4 states of one channel, N / 4 lanes per
// channel; no staging.
template <int N>
__global__ void __launch_bounds__(kStepThreads)
    selective_scan_step_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ dskip,
        const float* __restrict__ h0, float* __restrict__ y,
        float* __restrict__ h_last, int Di, long long lanes_total) {
  constexpr int L = N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * kStepThreads +
                      threadIdx.x;
  const bool live = i < lanes_total;
  const long long ch = (live ? i : lanes_total - 1) / L;  // b·Di + d
  const long long b = ch / Di, d = ch % Di;
  const int n0 = static_cast<int>(i % L) * 4;
  float a2[4], h[4] = {0.f, 0.f, 0.f, 0.f}, bv[4], cv[4];
  load_run(a2, a + d * N + n0, aligned16(a));
#pragma unroll
  for (int k = 0; k < 4; ++k) a2[k] *= -kLog2e;
  if (h0 != nullptr) load_run(h, h0 + ch * N + n0, aligned16(h0));
  load_run(bv, bm + b * N + n0, aligned16(bm));
  load_run(cv, cm + b * N + n0, aligned16(cm));
  const float xv = x[ch];
  const float p = lane_sum<L>(step(h, a2, bv, cv, dt[ch], xv));
  if (!live) return;
  if (n0 == 0) y[ch] = fmaf(xv, dskip[d], p);
  store_run(h_last + ch * N + n0, h, aligned16(h_last));
}

template <int N>
int launch_scan(const float* x, const float* dt, const float* bm,
                const float* cm, const float* a, const float* dskip,
                const float* h0, float* y, float* h_last, float* hc, int B,
                int S, int Di, cudaStream_t st) {
  constexpr int kCh = kThreads / lanes_for(N);
  const long long blocks = static_cast<long long>(B) * ((Di + kCh - 1) / kCh);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  selective_scan_kernel<N>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, dt, bm, cm, a, dskip, h0, y, h_last, hc, S, Di);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_step(const float* x, const float* dt, const float* bm,
                const float* cm, const float* a, const float* dskip,
                const float* h0, float* y, float* h_last, int B, int Di,
                cudaStream_t st) {
  const long long lanes = static_cast<long long>(B) * Di * (N / 4);
  const long long blocks = (lanes + kStepThreads - 1) / kStepThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  selective_scan_step_kernel<N>
      <<<static_cast<unsigned>(blocks), kStepThreads, 0, st>>>(
      x, dt, bm, cm, a, dskip, h0, y, h_last, Di, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Lanes per channel of the prefill kernel for state width N (4, 8, 16 or
// 32), -1 for a width the kernel does not take.
extern "C" long long selective_scan_lanes(int N) {
  return N == 4 || N == 8 || N == 16 || N == 32 ? lanes_for(N) : -1;
}

// Steps between two saved chunk states (hc).
extern "C" long long selective_scan_chunk() { return kChunk; }

// Plain C entry point (loaded with ctypes). h0 and hc may be null. N must
// be 4, 8, 16 or 32. S = 1 without hc runs the decode kernel. Launches on
// `stream` and returns cudaGetLastError() as an int (0 on success).
extern "C" int selective_scan_f32(const void* x, const void* dt,
                                  const void* bm, const void* cm,
                                  const void* a, const void* dskip,
                                  const void* h0, void* y, void* h_last,
                                  void* hc, int B, int S, int Di, int N,
                                  void* stream) {
  if (B <= 0 || Di <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(dskip);
  const float* hf = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* lf = static_cast<float*>(h_last);
  float* cf_out = static_cast<float*>(hc);
  if (S == 1 && cf_out == nullptr) {
    switch (N) {
      case 4: return launch_step<4>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, Di, st);
      case 8: return launch_step<8>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, Di, st);
      case 16: return launch_step<16>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, Di, st);
      case 32: return launch_step<32>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, Di, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (N) {
    case 4: return launch_scan<4>(xf, dtf, bf, cf, af, df, hf, yf, lf, cf_out, B, S, Di, st);
    case 8: return launch_scan<8>(xf, dtf, bf, cf, af, df, hf, yf, lf, cf_out, B, S, Di, st);
    case 16: return launch_scan<16>(xf, dtf, bf, cf, af, df, hf, yf, lf, cf_out, B, S, Di, st);
    case 32: return launch_scan<32>(xf, dtf, bf, cf, af, df, hf, yf, lf, cf_out, B, S, Di, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
