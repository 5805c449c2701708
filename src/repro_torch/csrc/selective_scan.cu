// selective_scan — the Mamba-1 forward scan, one call per layer of prefill
// and of every decode step:
//
//   h_t = exp(-dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t
//   y_t = C_t · h_t + D ⊙ x_t
//
// x, dt, y [B, S, Di]; B_t, C_t [B, S, N]; A [Di, N]; D [Di]; h0, h_last
// [B, Di, N]; all float32, row-major and contiguous. h0 may be null (zero).
//
// Replaces: src/repro/kernels/selective_scan.py::selective_scan (body
// _kernel). The TPU kernel tiles Di into 128-lane blocks, pads S to a
// chunk, and walks the chunks one after another on one core with the state
// [B, block_d, N] in VMEM scratch. Here the recurrence is independent per
// (b, d, n), so every state element is a thread that keeps h in a register
// for the whole sequence, and nothing needs carrying between blocks:
//
//   * N lanes of a warp share one (b, d) channel, one lane per state n; a
//     block of 256 threads holds 256 / N consecutive channels of one batch
//     row (16 at N = 16: 524,288 threads at B = 4, Di = 8192);
//   * the block stages kChunk timesteps at a time in shared memory: its
//     channels' x and dt (rows of 256 / N contiguous floats) and the
//     step's B_t and C_t (shared by all its channels), loaded with
//     neighbouring threads on neighbouring addresses;
//   * each lane steps h, then y_t is a __shfl_xor_sync reduction of h·C
//     over the channel's N lanes, plus D·x_t, staged in shared memory and
//     stored a chunk at a time as contiguous rows.
//
// Bound on this card: bytes (x, dt read and y written once: 12 bytes per
// (b, t, d)) against ~6 float32 operations and one exp per (b, t, d, n).
// At the prefill shape (B 4, S 512, Di 8192, N 16) that is ~201 MB, 0.060 ms
// at 3.35 TB/s, against 1.6 GFLOP, 0.024 ms at 67 TFLOP/s. The exps (268 M)
// run on the SFUs and the y reduction costs log2(N) shuffles a step; both
// may cost more than the bytes. Making it fast (TMA staging, a chunked
// parallel scan over S) is later work.
//
// expf is the precise one (no --use_fast_math), so the result stays within
// float32 rounding of the sequential plain version; the two differ in the
// order of the N-term dot and where the compiler contracts a multiply-add.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // timesteps staged in shared memory per pass

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int S, int Di) {
  constexpr int kCh = kThreads / N;  // channels per block
  __shared__ float xs[kChunk][kCh];
  __shared__ float ds[kChunk][kCh];
  __shared__ float ys[kChunk][kCh];
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];

  const int blocks_per_row = (Di + kCh - 1) / kCh;
  const long long b = blockIdx.x / blocks_per_row;
  const int d0 = (blockIdx.x % blocks_per_row) * kCh;
  const int width = min(kCh, Di - d0);  // live channels of this block
  const int c = threadIdx.x / N, n = threadIdx.x % N;
  const bool live = c < width;
  const long long d = d0 + c;

  const float an = live ? a[d * N + n] : 0.f;
  const float dn = live ? dskip[d] : 0.f;
  const long long hidx = (b * Di + d) * N + n;
  float h = (live && h0 != nullptr) ? h0[hidx] : 0.f;

  const long long row0 = b * S;  // row (b, 0) of x, dt, y, B and C
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int T = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < T * kCh; i += kThreads) {
      const int t = i / kCh, j = i % kCh;
      const long long off = (row0 + t0 + t) * Di + d0 + j;
      xs[t][j] = j < width ? x[off] : 0.f;
      ds[t][j] = j < width ? dt[off] : 0.f;
    }
    for (int i = threadIdx.x; i < T * N; i += kThreads) {
      const int t = i / N, j = i % N;
      const long long off = (row0 + t0 + t) * N + j;
      bs[t][j] = bm[off];
      cs[t][j] = cm[off];
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const float dtv = ds[t][c], xv = xs[t][c];
      const float decay = expf(-dtv * an);
      h = decay * h + (dtv * xv) * bs[t][n];
      float p = h * cs[t][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[t][c] = p + xv * dn;
    }
    __syncthreads();
    // the next pass's loads write only xs, ds, bs and cs, and its compute
    // starts after the next __syncthreads, so ys is free again by then
    for (int i = threadIdx.x; i < T * kCh; i += kThreads) {
      const int t = i / kCh, j = i % kCh;
      if (j < width) y[(row0 + t0 + t) * Di + d0 + j] = ys[t][j];
    }
  }
  if (live) h_last[hidx] = h;
}

template <int N>
int launch(const float* x, const float* dt, const float* bm, const float* cm,
           const float* a, const float* dskip, const float* h0, float* y,
           float* h_last, int B, int S, int Di, cudaStream_t st) {
  constexpr int kCh = kThreads / N;
  const long long blocks = static_cast<long long>(B) * ((Di + kCh - 1) / kCh);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, dt, bm, cm, a, dskip, h0, y, h_last, S, Di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). h0 may be null. N must be 4, 8,
// 16 or 32 (the lanes of one channel divide a warp). Launches on `stream`
// and returns cudaGetLastError() as an int (0 on success).
extern "C" int selective_scan_f32(const void* x, const void* dt,
                                  const void* bm, const void* cm,
                                  const void* a, const void* dskip,
                                  const void* h0, void* y, void* h_last,
                                  int B, int S, int Di, int N, void* stream) {
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
  switch (N) {
    case 4:
      return launch<4>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, S, Di, st);
    case 8:
      return launch<8>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, S, Di, st);
    case 16:
      return launch<16>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, S, Di, st);
    case 32:
      return launch<32>(xf, dtf, bf, cf, af, df, hf, yf, lf, B, S, Di, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
