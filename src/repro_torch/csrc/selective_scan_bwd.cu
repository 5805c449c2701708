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
// Bound on this card: at falcon-mamba-7b's training shape (B 2, S 512,
// Di 8192, N 16) the bytes that must move (x, dt, dy, B, C, the chunk
// states, and the seven gradients) are ~203 MB, 0.061 ms at 3.35 TB/s;
// the recompute's B·S·Di·N = 134 M exps take 0.032 ms at 16 a clock on
// each of 132 SMs at 1.98 GHz. So bytes bound it.
//
// The first design gave each thread 4 states of one channel and had it
// walk all S steps twice, the chunks from the last: 65,536 threads at that
// shape, a quarter of the card's warp slots, at 167 registers 3 blocks an
// SM and a second wave; every step's loads exposed (0.849 ms, ~1,600
// clocks a step); 24 shuffles a step and 512 atomics a block and chunk for
// dB and dC (8.4 M atomics on 32,768 floats).
//
// This design is parallel over the chunks:
//   * the carry across chunks is affine. Chunk c takes the carry K that
//     its right neighbour sends and sends P_c ⊙ K + L_c to its left, with
//     P_c = Π_{t∈c} a_t and L_c what it sends from a zero carry-in,
//     L_c = Σ_{t∈c} (Π_{s≤t, s∈c} a_s) dy_t C_t;
//   * a lane owns one chunk, two channels and two states of each (kD · kP
//     chains, so dB and dC, summed over channels, need only kP states of
//     accumulators); a warp's lanes are kC = 64 / N consecutive chunks
//     (a span of 16·kC steps) times the N / 2 state groups. Each lane
//     recomputes its chunk forward from the staged hc with the forward's
//     own arithmetic (ex2.approx of dt · A2, A2 = −A log2 e, and the same
//     fmaf), so the states are the forward's bit for bit, and keeps them in
//     registers; the same pass forms P_c and L_c. A reverse Kogge-Stone
//     scan over the chunk lanes (log2 kC shuffle levels of (P₂, L₂)∘(P₁,
//     L₁) = (P₂P₁, P₂L₁ + L₂)) gives every lane its true carry-in; spans
//     are walked from the last, the carry between them kept in dh0. Then
//     each lane walks its 16 steps backwards once, issuing the decay again;
//   * a block of 4 warps stays on one batch row and walks groups of 8
//     channels (one 32-byte row of x, dt, dy), persistently: two blocks an
//     SM, each a share of the row's groups, warp w channels 2w and 2w + 1.
//     A group's x, dt, dy, chunk states, A and carries come in by 16-byte
//     cp.async, the next group's under this one's compute, x, dt and dy as
//     [step of chunk][chunk][channel] rows, so a warp reads kC rows a step;
//     B and C come in once a span. Every input crosses device memory once;
//   * dB and dC add up in registers over every channel a warp walks and
//     leave the block once a span: the warps' sums meet in shared memory,
//     then one atomicAdd per (t, n) and block. dx and ddt (sums over n):
//     each state group writes its partial sums to its own shared plane (no
//     shuffles or atomics in the walk) and the block sums the planes as it
//     writes the group out, coalesced, with dD; dA sums over a warp's
//     chunk lanes by shuffles, one atomicAdd a state and span.
// What holds it above its bound (tools/probe_kernels.py's ablations,
// PERF.md): a unit (a group over a span) stages, computes, then writes
// out, between block barriers, so its write-out does not run under its
// compute; the staged loads alone reach ~60% of the memory rate; and at
// 255 registers a thread (64 recomputed states, 64 dB/dC sums) an SM
// holds 8 warps, which leaves the backward walk far from its ex2 rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // must equal selective_scan.cu's kChunk
constexpr int kP = 2;       // states a thread owns
constexpr int kD = 2;       // channels a thread owns
constexpr int kWarps = 4;
constexpr int kBlocksPerSm = 2;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = kD * kWarps;  // channels staged together, 2 a warp
// Row stride of the staged x, dt, dy: 16-byte rows for 16-byte copies; a
// warp's 8-byte reads of up to 8 rows (kC) fall in distinct bank pairs.
constexpr int kCW = kGroup + 4;
// Row stride of the Σ_n planes: a half-warp's 8-byte writes (kC rows ×
// state groups) fall in distinct bank pairs at N = 16 and N = 4.
constexpr int kOW = kGroup + 2;
// A block's share of an SM's 228 KiB, less the 1 KiB each block reserves
constexpr int kSmemFloats = (233472 / kBlocksPerSm - 1024) / 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGroup == 8 || kGroup == 16 || kGroup == 32,
              "the write-out's dD sum maps a thread's channel to its lane");

template <int N>
struct Layout {
  static constexpr int kNG = N / kP;        // state groups: lanes a chunk
  static constexpr int kC = 32 / kNG;       // chunks a warp walks at once
  static constexpr int kSpan = kC * kChunk;  // steps of a span
  // B/C row stride: the 8-byte reads of a half-warp (kC chunks × the
  // state groups) fall in distinct bank pairs.
  static constexpr int kBS = 3 * N / 2;
  // x, dt, dy of a group over the span; its chunk states [chunk][c][n],
  // A [c][n] and the carry from the right [c][n]
  static constexpr int kStage =
      3 * kSpan * kCW + kC * kGroup * N + 2 * kGroup * N;
  // Σ_n g B and Σ_n A q of each state group [jn][2][row][kOW], a group's
  // planes 8 floats (mod 32) apart
  static constexpr int kJS = 2 * kSpan * kOW + 8;
  static constexpr int kOut = kNG * kJS;
  static constexpr int kBC = 2 * kSpan * kBS;      // B, C of a span
  // dB, dC of half the warps (the other half add theirs in)
  static constexpr int kAcc = kWarps / 2 * 2 * kSpan * N;
  static constexpr int kRest = kOut + kBC + kAcc + kWarps * kGroup;
  static constexpr int kStages =
      2 * kStage + kRest <= kSmemFloats ? 2 : 1;
  static constexpr int kFloats = kStages * kStage + kRest;
  static_assert(kFloats <= kSmemFloats, "fits shared memory");
  static_assert(kC >= 1 && kC * kNG == 32, "state groups fit a warp");
};

// `bytes` (4 or 16) from global to shared, asynchronously; zeros when
// !valid.
template <int bytes>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(gmem), "n"(bytes), "r"(valid ? bytes : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__host__ __device__ __forceinline__ bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Two consecutive floats at p (one 8-byte access when `vec`).
__device__ __forceinline__ void load2(float (&v)[2], const float* p,
                                      bool vec) {
  if (vec) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0], v[1] = p[1];
  }
}

__device__ __forceinline__ void store2(float* p, const float (&v)[2],
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0], p[1] = v[1];
  }
}

// 2^x, as selective_scan.cu computes the decay.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Block (g, b): batch row b, channel groups g, g + gridDim.x, ...; in a
// group, warp w owns channels 2w and 2w + 1; in a warp, lane jn·kC + i owns
// chunk i of the span and states [2 jn, 2 jn + 2).
template <int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    selective_scan_bwd_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ dskip,
        const float* __restrict__ hc, const float* __restrict__ dy,
        const float* __restrict__ dh_last, float* __restrict__ dx,
        float* __restrict__ ddt, float* __restrict__ dB,
        float* __restrict__ dC, float* __restrict__ dA,
        float* __restrict__ dD, float* __restrict__ dh0, int S, int Di) {
  using Lay = Layout<N>;
  constexpr int kNG = Lay::kNG, kC = Lay::kC, kSpan = Lay::kSpan;
  constexpr int kBS = Lay::kBS, kStages = Lay::kStages;
  constexpr int kPlane = kSpan * kCW;
  extern __shared__ __align__(16) float smem[];
  float* const stage = smem;                         // [kStages][3][row][kCW]
  float* const outp = stage + kStages * Lay::kStage;  // [jn][2][row][kOW]
  float* const bs = outp + Lay::kOut;                // [row][kBS]
  float* const cs = bs + kSpan * kBS;
  float* const accs = cs + kSpan * kBS;              // [warp/2][2][row][N]
  float* const dds = accs + Lay::kAcc;               // [warp][kGroup]

  const int groups = (Di + kGroup - 1) / kGroup;
  if (static_cast<int>(blockIdx.x) >= groups) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = lane % kC, jn = lane / kC, n0 = jn * kP;
  const long long b = blockIdx.y;
  const int chunks = (S + kChunk - 1) / kChunk;
  const int spans = (chunks + kC - 1) / kC;
  const long long row0 = b * S;  // row (b, 0) of x, dt, dy, B and C
  const bool vec_0 = aligned8(dh0);

  // Rows of a span's staged arrays: step k of chunk i is row k·kC + i, so
  // a warp reads kC consecutive rows at a step.
  auto row_of = [](int tl) { return (tl % kChunk) * kC + tl / kChunk; };
  // What channels [kGroup jg, kGroup (jg + 1)) need over span sp, into
  // stage buffer `buf`: x, dt, dy; the chunk states; A; the carry from the
  // right (dh_last for the last span, else what the span to the right
  // sent, kept in dh0). Zeros past S, past Di and for a null dh_last.
  // Every copy 16 bytes when the rows allow (Di % 4 == 0, aligned bases).
  const bool vec16 = Di % 4 == 0 && aligned16(x) && aligned16(dt) &&
                     aligned16(dy) && aligned16(hc) && aligned16(a) &&
                     aligned16(dh0) &&
                     (dh_last == nullptr || aligned16(dh_last));
  auto stage_group = [&](int buf, int sp, int jg) {
    float* dst = stage + buf * Lay::kStage;
    const long long d0 = static_cast<long long>(jg) * kGroup;
    const int t_base = sp * kSpan;
    const int w = vec16 ? 4 : 1;  // floats a copy
    for (int e = threadIdx.x; e < kSpan * kGroup / w; e += kThreads) {
      const int tl = e / (kGroup / w), c = e % (kGroup / w) * w;
      const bool ok = t_base + tl < S && d0 + c < Di;
      const long long off = ok ? (row0 + t_base + tl) * Di + d0 + c : 0;
      const int o = row_of(tl) * kCW + c;
      if (vec16) {
        cp_async<16>(dst + o, x + off, ok);
        cp_async<16>(dst + kPlane + o, dt + off, ok);
        cp_async<16>(dst + 2 * kPlane + o, dy + off, ok);
      } else {
        cp_async<4>(dst + o, x + off, ok);
        cp_async<4>(dst + kPlane + o, dt + off, ok);
        cp_async<4>(dst + 2 * kPlane + o, dy + off, ok);
      }
    }
    float* hs_dst = dst + 3 * kPlane;
    for (int e = threadIdx.x * w; e < kC * kGroup * N; e += kThreads * w) {
      const int c = (e / N) % kGroup, ci = sp * kC + e / (N * kGroup);
      const bool ok = d0 + c < Di && ci < chunks;
      const long long off =
          ok ? ((b * chunks + ci) * Di + d0) * N + e % (kGroup * N) : 0;
      if (vec16)
        cp_async<16>(hs_dst + e, hc + off, ok);
      else
        cp_async<4>(hs_dst + e, hc + off, ok);
    }
    float* a_dst = hs_dst + kC * kGroup * N;
    const float* right = sp < spans - 1 ? dh0 : dh_last;
    for (int e = threadIdx.x * w; e < kGroup * N; e += kThreads * w) {
      const bool ok = d0 + e / N < Di, okr = ok && right != nullptr;
      const float* ra = a + (ok ? d0 * N + e : 0);
      const float* rk = okr ? right + (b * Di + d0) * N + e : a;
      if (vec16) {
        cp_async<16>(a_dst + e, ra, ok);
        cp_async<16>(a_dst + kGroup * N + e, rk, okr);
      } else {
        cp_async<4>(a_dst + e, ra, ok);
        cp_async<4>(a_dst + kGroup * N + e, rk, okr);
      }
    }
  };

  for (int sp = spans - 1; sp >= 0; --sp) {
    const int t_base = sp * kSpan;
    float accB[kChunk][kP], accC[kChunk][kP];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
#pragma unroll
      for (int s = 0; s < kP; ++s) accB[k][s] = accC[k][s] = 0.f;

    __syncthreads();  // the last span's readers of bs, cs, accs, stages
    for (int e = threadIdx.x; e < kSpan * N; e += kThreads) {
      const int tl = e / N, n = e % N;
      const bool ok = t_base + tl < S;
      const long long off = ok ? (row0 + t_base + tl) * N + n : 0;
      const int o = row_of(tl) * kBS + n;
      cp_async<4>(bs + o, bm + off, ok);
      cp_async<4>(cs + o, cm + off, ok);
    }
    cp_async_commit();

    int it = 0;
    for (int jg = blockIdx.x; jg < groups;
         jg += static_cast<int>(gridDim.x), ++it) {
      const int buf = kStages == 2 ? (it & 1) : 0;
      if (kStages == 1 || it == 0) {
        stage_group(buf, sp, jg);
        cp_async_commit();
      }
      if (kStages == 2 && jg + static_cast<int>(gridDim.x) < groups) {
        stage_group(buf ^ 1, sp, jg + gridDim.x);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* const sx = stage + buf * Lay::kStage;
      const float* const sd = sx + kPlane;
      const float* const sy = sd + kPlane;
      const float* const shc = sy + kPlane;             // [chunk][c][n]
      const float* const sa = shc + kC * kGroup * N;    // [c][n]
      const float* const sk = sa + kGroup * N;          // [c][n]
      const int c0 = kD * warp;  // this warp's first channel of the group
      const long long d = static_cast<long long>(jg) * kGroup + c0;

      if (d < Di) {
        bool ok[kD];
        float a2[kD][kP], av[kD][kP], h0c[kD][kP], kin[kD][kP];
#pragma unroll
        for (int c = 0; c < kD; ++c) {
          ok[c] = d + c < Di;
          load2(av[c], sa + (c0 + c) * N + n0, true);
          load2(h0c[c], shc + (i * kGroup + c0 + c) * N + n0, true);
          load2(kin[c], sk + (c0 + c) * N + n0, true);
#pragma unroll
          for (int s = 0; s < kP; ++s) a2[c][s] = av[c][s] * -kLog2e;
        }

        // recompute the chunk forward as the forward computed it, with
        // P = Π a_t and L = Σ_t (Π_{s≤t} a_s) dy_t C_t
        float hs[kChunk][kD][kP], pm[kD][kP], lm[kD][kP];
#pragma unroll
        for (int c = 0; c < kD; ++c)
#pragma unroll
          for (int s = 0; s < kP; ++s) pm[c][s] = 1.f, lm[c][s] = 0.f;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int o = k * kC + i;
          float xv[kD], dtv[kD], dyv[kD], bv[kP], cv[kP];
          load2(xv, sx + o * kCW + c0, true);
          load2(dtv, sd + o * kCW + c0, true);
          load2(dyv, sy + o * kCW + c0, true);
          load2(bv, bs + o * kBS + n0, true);
          load2(cv, cs + o * kBS + n0, true);
#pragma unroll
          for (int c = 0; c < kD; ++c) {
            const float dxv = dtv[c] * xv[c];
#pragma unroll
            for (int s = 0; s < kP; ++s) {
              const float at = ex2(dtv[c] * a2[c][s]);
              const float hp = k > 0 ? hs[k > 0 ? k - 1 : 0][c][s] : h0c[c][s];
              hs[k][c][s] = fmaf(at, hp, dxv * bv[s]);
              pm[c][s] *= at;
              lm[c][s] = fmaf(pm[c][s], dyv[c] * cv[s], lm[c][s]);
            }
          }
        }
        // reverse scan over the chunk lanes: lane i ends with the map of
        // chunks i..kC-1 composed; its carry-in is lane i + 1's map
        // applied to kin
#pragma unroll
        for (int off = 1; off < kC; off <<= 1) {
#pragma unroll
          for (int c = 0; c < kD; ++c)
#pragma unroll
            for (int s = 0; s < kP; ++s) {
              const float pn = __shfl_down_sync(kFull, pm[c][s], off, kC);
              const float ln = __shfl_down_sync(kFull, lm[c][s], off, kC);
              if (i + off < kC) {
                lm[c][s] = fmaf(pm[c][s], ln, lm[c][s]);
                pm[c][s] *= pn;
              }
            }
        }
        float carry[kD][kP], da[kD][kP];
#pragma unroll
        for (int c = 0; c < kD; ++c)
#pragma unroll
          for (int s = 0; s < kP; ++s) {
            const float pn = __shfl_down_sync(kFull, pm[c][s], 1, kC);
            const float ln = __shfl_down_sync(kFull, lm[c][s], 1, kC);
            carry[c][s] = i == kC - 1 ? kin[c][s] : fmaf(pn, kin[c][s], ln);
            da[c][s] = 0.f;
          }

        // walk the chunk backwards with its true carry
#pragma unroll
        for (int k = kChunk - 1; k >= 0; --k) {
          const int o = k * kC + i;
          float xv[kD], dtv[kD], dyv[kD], bv[kP], cv[kP];
          load2(xv, sx + o * kCW + c0, true);
          load2(dtv, sd + o * kCW + c0, true);
          load2(dyv, sy + o * kCW + c0, true);
          load2(bv, bs + o * kBS + n0, true);
          load2(cv, cs + o * kBS + n0, true);
          float gb[kD], aq[kD];
#pragma unroll
          for (int c = 0; c < kD; ++c) {
            const float dxv = dtv[c] * xv[c];
            gb[c] = aq[c] = 0.f;
#pragma unroll
            for (int s = 0; s < kP; ++s) {
              const float at = ex2(dtv[c] * a2[c][s]);
              const float hp = k > 0 ? hs[k > 0 ? k - 1 : 0][c][s] : h0c[c][s];
              const float g = fmaf(dyv[c], cv[s], carry[c][s]);
              gb[c] = fmaf(g, bv[s], gb[c]);
              const float qv = g * (at * hp);
              aq[c] = fmaf(av[c][s], qv, aq[c]);
              da[c][s] = fmaf(dtv[c], qv, da[c][s]);
              accB[k][s] = fmaf(g, dxv, accB[k][s]);
              accC[k][s] = fmaf(dyv[c], hs[k][c][s], accC[k][s]);
              carry[c][s] = at * g;
            }
          }
          // this state group's Σ_n g B and Σ_n A q of both channels; the
          // write-out sums the state groups
          float* dst = outp + jn * Lay::kJS + o * kOW + c0;
          store2(dst, gb, true);
          store2(dst + kSpan * kOW, aq, true);
        }
        // chunk sp·kC sends its carry left: the next span's, or dh0
#pragma unroll
        for (int c = 0; c < kD; ++c) {
          if (i == 0 && ok[c])
            store2(dh0 + (b * Di + d + c) * N + n0, carry[c], vec_0);
#pragma unroll
          for (int s = 0; s < kP; ++s) {
#pragma unroll
            for (int off = 1; off < kC; off <<= 1)
              da[c][s] += __shfl_xor_sync(kFull, da[c][s], off);
            if (i == 0 && ok[c])
              atomicAdd(dA + (d + c) * N + n0 + s, -da[c][s]);
          }
        }
      }
      __syncthreads();

      // write dx and ddt of the group, and its Σ dy x for dD; a thread
      // keeps one channel (kThreads is a multiple of kGroup)
      {
        const int c = threadIdx.x % kGroup;
        const long long dc = static_cast<long long>(jg) * kGroup + c;
        const float dn = dc < Di ? dskip[dc] : 0.f;
        float xy = 0.f;
        for (int e = threadIdx.x; e < kSpan * kGroup; e += kThreads) {
          const int tl = e / kGroup;
          if (dc < Di && t_base + tl < S) {
            const int row = row_of(tl), o = row * kCW + c;
            const float* po = outp + row * kOW + c;
            float gb = 0.f, aq = 0.f;
#pragma unroll
            for (int j = 0; j < kNG; ++j) {
              gb += po[j * Lay::kJS];
              aq += po[j * Lay::kJS + kSpan * kOW];
            }
            const long long r = (row0 + t_base + tl) * Di + dc;
            const float xv = sx[o], dyv = sy[o];
            dx[r] = fmaf(gb, sd[o], dn * dyv);
            ddt[r] = fmaf(xv, gb, -aq);
            xy = fmaf(dyv, xv, xy);
          }
        }
#pragma unroll
        for (int off = kGroup; off < 32; off <<= 1)
          xy += __shfl_xor_sync(kFull, xy, off);
        if (lane < kGroup) dds[warp * kGroup + lane] = xy;
        __syncthreads();  // also: the stage buffer and outp are free
        if (threadIdx.x < kGroup && dc < Di) {
          float sum = 0.f;
          for (int w = 0; w < kWarps; ++w) sum += dds[w * kGroup + c];
          atomicAdd(dD + dc, sum);
        }
      }
    }

    // dB and dC of the span: every warp's sums over its channels meet in
    // shared memory (the upper half of the warps store theirs, the lower
    // half add theirs in), then one atomicAdd per (t, n) and block
    constexpr int kHalf = kWarps / 2;
    float* const pw = accs + (warp % kHalf) * 2 * kSpan * N;
    for (int r2 = 0; r2 < 2; ++r2) {
      if ((warp < kHalf) == (r2 == 1)) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          float* pb = pw + (k * kC + i) * N + n0;
          float* pc = pb + kSpan * N;
          if (r2 == 1) {
            float ob[kP], oc[kP];
            load2(ob, pb, true);
            load2(oc, pc, true);
#pragma unroll
            for (int s = 0; s < kP; ++s) {
              accB[k][s] += ob[s];
              accC[k][s] += oc[s];
            }
          }
          store2(pb, accB[k], true);
          store2(pc, accC[k], true);
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < 2 * kSpan * N; e += kThreads) {
      const int r = e % (kSpan * N), row = r / N, n = r % N;
      const int tl = (row % kC) * kChunk + row / kC;
      if (t_base + tl < S) {
        float v = 0.f;
        for (int w = 0; w < kHalf; ++w) v += accs[w * 2 * kSpan * N + e];
        atomicAdd((e < kSpan * N ? dB : dC) + (row0 + t_base + tl) * N + n,
                  v);
      }
    }
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* bm, const float* cm,
           const float* a, const float* dskip, const float* hc,
           const float* dy, const float* dh_last, float* dx, float* ddt,
           float* dB, float* dC, float* dA, float* dD, float* dh0, int B,
           int S, int Di, cudaStream_t st) {
  using Lay = Layout<N>;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Lay::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // kBlocksPerSm blocks an SM, the row's channel groups shared out evenly
  const int groups = (Di + kGroup - 1) / kGroup;
  int per_row = (sms * kBlocksPerSm + B - 1) / B;
  per_row = per_row < 1 ? 1 : (per_row > groups ? groups : per_row);
  const int each = (groups + per_row - 1) / per_row;
  per_row = (groups + each - 1) / each;
  selective_scan_bwd_kernel<N><<<dim3(per_row, B), kThreads, bytes, st>>>(
      x, dt, bm, cm, a, dskip, hc, dy, dh_last, dx, ddt, dB, dC, dA, dD, dh0,
      S, Di);
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
