// Backward of the fused anti-aliased SnakeBeta activation for Hopper (sm_90a).
//
// The gradient of csrc/anti_alias.cu (K1), which replaces the TPU kernel
// indextts_tpu/ops/pallas/anti_alias.py (fused_anti_alias_activation, :242).
// That TPU kernel has no backward: JAX differentiates the XLA composition
// ops/filters.anti_aliased_activation instead.  This kernel replaces none; it
// is the backward of K1 that vocoder training runs at every activation.
//
// For fp32 x, g = dL/dy [B, C, T] and alpha, beta [C] it writes
// grad_x [B, C, T] and per-channel grad_alpha, grad_beta.  In the polyphase
// form of K1 (xc[m] = x[clamp(m, 0, T-1)], f the 12 taps):
//
//   u_e[n]  = 2 sum_j f[2j] xc[n+j-3]         u_o[n]  = 2 sum_j f[2j+1] xc[n+j-2]
//   ga_e[n] = sum_j f[2j+1] g[n+2-j]          ga_o[n] = sum_j f[2j] g[n+3-j]     (g = 0 outside)
//     + the taps that the forward clamps: ga_e[0] takes those reading A below 0,
//       ga_o[T-1] those reading A above 2T-1
//   gu      = ga (1 + (a/b') sin(2 a u)),  b' = b + 1e-9
//   grad_x[m] = sum_j 2 f[2j] gu_e[m-j+3] + 2 f[2j+1] gu_o[m-j+2]
//     + for m = 0 and m = T-1 the terms of the columns the forward clamped
//   grad_alpha = sum ga (u/b') sin(2 a u),  grad_beta = -sum ga sin^2(a u) / b'^2
//     (times a and b under logscale)
//
// Bound on the H100: it reads x and g once and writes grad_x once, 12 bytes
// an element, against about 90 flops an element; the bytes bound it (about
// 1.2 ms for the 334 M elements of a vocoder training step at batch 8 and 24
// codes).  A simple design, right first:
// - Recompute, don't save.  A block of kCols threads owns kCols consecutive
//   columns of one row.  It stages x (clamped) and g (zero outside the row)
//   for its columns and 6 halo columns each side in shared memory, then
//   recomputes u and ga, and from them gu, for its pairs and 3 halo pairs
//   each side, in shared memory too.  The 2x-rate signal never reaches
//   device memory.  Each thread then sums its column's 12 taps of gu.
// - Edges by correction, not by branches per tap: the clamps touch only
//   ga_e[0], ga_o[T-1], grad_x[0] and grad_x[T-1], which add fixed partial
//   sums of the taps (host-computed) times g or gu.  Any T >= 1 is taken.
// - Deterministic per-channel sums: each block reduces its owned pairs'
//   terms in a fixed tree into one partial per (row, tile), written to a
//   scratch buffer; a second kernel sums a channel's partials in a fixed
//   order.  No float atomics, so two runs give bit-equal gradients.
// - sin and cos of a u take K1's reduction modulo pi and one __sincosf:
//   sin(2 a u) = 2 sin(r) cos(r) and sin^2(a u) = sin^2(r) for r = a u - k pi.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 12;
constexpr int kCols = 256;                 // columns (and threads) per block
constexpr int kXWin = kCols + 12;          // x and g columns c0-6 .. c0+kCols+5
constexpr int kPWin = kCols + 6;           // pairs c0-3 .. c0+kCols+2
constexpr int kWarps = kCols / 32;
constexpr int kSumThreads = 256;

constexpr float kPiHi = 3.140625f;
constexpr float kPiLo = 9.67653589793e-4f;
constexpr float kInvPi = 0.318309886183791f;
constexpr float kRound = 12582912.0f;

struct BwdTaps {
  float up[kTaps];     // 2 f
  float down[kTaps];   // f
  float gl[3];         // ga_e[0] += gl[s] g[s]:        sum_{k < 5-2s} f[k]
  float gr[3];         // ga_o[T-1] += gr[s] g[T-1-s]:  sum_{k > 6+2s} f[k]
  float xle[3];        // grad_x[0] += xle[n] gu_e[n]:  sum_{j < 3-n} 2 f[2j]
  float xlo[2];        // grad_x[0] += xlo[n] gu_o[n]:  sum_{j < 2-n} 2 f[2j+1]
  float xre[2];        // grad_x[T-1] += xre[s] gu_e[T-1-s]:  sum_{j >= 4+s} 2 f[2j]
  float xro[3];        // grad_x[T-1] += xro[s] gu_o[T-1-s]:  sum_{j >= 3+s} 2 f[2j+1]
};

__device__ __forceinline__ void sincos_reduced(float u, float a_over_pi, float a, float* s,
                                               float* c) {
  const float theta = u * a;
  const float k = fmaf(u, a_over_pi, kRound) - kRound;
  float r = fmaf(k, -kPiHi, theta);
  r = fmaf(k, -kPiLo, r);
  __sincosf(r, s, c);
}

__global__ void __launch_bounds__(kCols)
anti_alias_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ alpha, const float* __restrict__ beta,
                           float* __restrict__ gx, float* __restrict__ partial, int C, int T,
                           int tiles, long long n_partials, int logscale, BwdTaps taps) {
  __shared__ float xs[kXWin];
  __shared__ float gs[kXWin];
  __shared__ float gue[kPWin];
  __shared__ float guo[kPWin];
  __shared__ float red[2][kWarps];

  const long long blk = blockIdx.x;
  const long long row = blk / tiles;
  const int tile = (int)(blk - row * tiles);
  const int ch = (int)(row % C);
  const int c0 = tile * kCols;
  const int tid = threadIdx.x;
  const float* xr = x + row * T;
  const float* gr = g + row * T;

  float a = alpha[ch];
  float b = beta[ch];
  if (logscale) {
    a = expf(a);
    b = expf(b);
  }
  const float inv_b = 1.0f / (b + 1e-9f);
  const float a_over_b = a * inv_b;
  const float a_over_pi = a * kInvPi;

  for (int q = tid; q < kXWin; q += kCols) {
    const int m = c0 - 6 + q;
    xs[q] = xr[min(max(m, 0), T - 1)];
    gs[q] = (m >= 0 && m < T) ? gr[m] : 0.f;
  }
  __syncthreads();

  // pairs n = c0 - 3 + p; this block owns (and sums) p in [3, kCols + 3)
  float pa = 0.f, pb = 0.f;
  for (int p = tid; p < kPWin; p += kCols) {
    const int n = c0 - 3 + p;
    float ge = 0.f, go = 0.f;
    if (n >= 0 && n < T) {
      float ue = 0.f, uo = 0.f, ae = 0.f, ao = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        ue = fmaf(taps.up[2 * j], xs[p + j], ue);
        uo = fmaf(taps.up[2 * j + 1], xs[p + j + 1], uo);
        ae = fmaf(taps.down[2 * j + 1], gs[p + 5 - j], ae);
        ao = fmaf(taps.down[2 * j], gs[p + 6 - j], ao);
      }
      if (n == 0) {   // g[s] sits at p + 3 + s (p = 3 here)
        for (int s = 0; s < 3 && s < T; ++s) ae = fmaf(taps.gl[s], gs[p + 3 + s], ae);
      }
      if (n == T - 1) {   // g[T-1-s] sits at p + 3 - s
        for (int s = 0; s < 3 && s < T; ++s) ao = fmaf(taps.gr[s], gs[p + 3 - s], ao);
      }
      float se, ce, so, co;
      sincos_reduced(ue, a_over_pi, a, &se, &ce);
      sincos_reduced(uo, a_over_pi, a, &so, &co);
      const float s2e = 2.f * se * ce;   // sin(2 a u)
      const float s2o = 2.f * so * co;
      ge = ae * fmaf(a_over_b, s2e, 1.f);
      go = ao * fmaf(a_over_b, s2o, 1.f);
      if (p >= 3 && p < kCols + 3) {
        pa += ae * ue * s2e + ao * uo * s2o;
        pb += ae * (se * se) + ao * (so * so);
      }
    }
    gue[p] = ge;
    guo[p] = go;
  }
  __syncthreads();

  const int m = c0 + tid;
  if (m < T) {
    // column m reads gu_e at pairs m-j+3 (p = tid+6-j) and gu_o at m-j+2 (p = tid+5-j)
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc = fmaf(taps.up[2 * j], gue[tid + 6 - j], acc);
      acc = fmaf(taps.up[2 * j + 1], guo[tid + 5 - j], acc);
    }
    if (m == 0) {   // pair n sits at p = n + 3 (c0 = 0); pairs past T-1 hold 0
#pragma unroll
      for (int n = 0; n < 3; ++n) acc = fmaf(taps.xle[n], gue[n + 3], acc);
#pragma unroll
      for (int n = 0; n < 2; ++n) acc = fmaf(taps.xlo[n], guo[n + 3], acc);
    }
    if (m == T - 1) {   // pair T-1-s sits at p = tid + 3 - s; pairs below 0 hold 0
#pragma unroll
      for (int s = 0; s < 2; ++s) acc = fmaf(taps.xre[s], gue[tid + 3 - s], acc);
#pragma unroll
      for (int s = 0; s < 3; ++s) acc = fmaf(taps.xro[s], guo[tid + 3 - s], acc);
    }
    gx[row * T + m] = acc;
  }

  // the block's partial sums, in a fixed order
  pa *= inv_b;
  pb *= -inv_b * inv_b;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pa += __shfl_down_sync(0xffffffffu, pa, off);
    pb += __shfl_down_sync(0xffffffffu, pb, off);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = pa;
    red[1][tid >> 5] = pb;
  }
  __syncthreads();
  if (tid == 0) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sa += red[0][w];
      sb += red[1][w];
    }
    partial[blk] = sa;
    partial[n_partials + blk] = sb;
  }
}

// One block a channel: the partials of rows (b, ch) for b < B, tiles in
// order, summed by each thread over a fixed stride and then in a fixed tree.
__global__ void __launch_bounds__(kSumThreads)
anti_alias_backward_sum(const float* __restrict__ partial, const float* __restrict__ alpha,
                        const float* __restrict__ beta, float* __restrict__ grad_alpha,
                        float* __restrict__ grad_beta, int B, int C, int tiles,
                        long long n_partials, int logscale) {
  __shared__ float red[2][kSumThreads];
  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const long long per_ch = (long long)B * tiles;
  float sa = 0.f, sb = 0.f;
  for (long long i = tid; i < per_ch; i += kSumThreads) {
    const long long b = i / tiles;
    const long long idx = (b * C + ch) * tiles + (i - b * tiles);
    sa += partial[idx];
    sb += partial[n_partials + idx];
  }
  red[0][tid] = sa;
  red[1][tid] = sb;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      red[0][tid] += red[0][tid + half];
      red[1][tid] += red[1][tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    float ga = red[0][0], gb = red[1][0];
    if (logscale) {
      ga *= expf(alpha[ch]);
      gb *= expf(beta[ch]);
    }
    grad_alpha[ch] = ga;
    grad_beta[ch] = gb;
  }
}

}  // namespace

// Floats of scratch that anti_alias_activation_backward needs for [B, C, T].
extern "C" long long anti_alias_backward_scratch_floats(int B, int C, int T) {
  const long long tiles = (T + kCols - 1) / kCols;
  return 2LL * B * C * tiles;
}

// x, g, gx: [B, C, T] fp32 contiguous; alpha, beta, grad_alpha, grad_beta:
// [C] fp32; scratch: anti_alias_backward_scratch_floats(B, C, T) floats.
// taps: the 12 filter taps, host memory.  Launches two kernels on `stream`
// and returns cudaGetLastError().
extern "C" int anti_alias_activation_backward(const void* x, const void* alpha, const void* beta,
                                              const void* g, void* gx, void* grad_alpha,
                                              void* grad_beta, void* scratch, int B, int C,
                                              int T, int logscale, const float* taps,
                                              void* stream) {
  BwdTaps tp;
  for (int k = 0; k < kTaps; ++k) {
    tp.up[k] = 2.f * taps[k];
    tp.down[k] = taps[k];
  }
  for (int s = 0; s < 3; ++s) {
    float l = 0.f, r = 0.f;
    for (int k = 0; k < 5 - 2 * s; ++k) l += taps[k];
    for (int k = 7 + 2 * s; k < kTaps; ++k) r += taps[k];
    tp.gl[s] = l;
    tp.gr[s] = r;
  }
  for (int n = 0; n < 3; ++n) {
    float e = 0.f;
    for (int j = 0; j < 3 - n; ++j) e += tp.up[2 * j];
    tp.xle[n] = e;
  }
  for (int n = 0; n < 2; ++n) {
    float o = 0.f;
    for (int j = 0; j < 2 - n; ++j) o += tp.up[2 * j + 1];
    tp.xlo[n] = o;
  }
  for (int s = 0; s < 2; ++s) {
    float e = 0.f;
    for (int j = 4 + s; j < 6; ++j) e += tp.up[2 * j];
    tp.xre[s] = e;
  }
  for (int s = 0; s < 3; ++s) {
    float o = 0.f;
    for (int j = 3 + s; j < 6; ++j) o += tp.up[2 * j + 1];
    tp.xro[s] = o;
  }
  const int tiles = (T + kCols - 1) / kCols;
  const long long n_partials = (long long)B * C * tiles;
  if (n_partials > 0x7fffffffLL || C > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(alpha);
  const auto* bf = static_cast<const float*>(beta);
  float* part = static_cast<float*>(scratch);
  anti_alias_backward_kernel<<<static_cast<unsigned>(n_partials), kCols, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), af, bf,
      static_cast<float*>(gx), part, C, T, tiles, n_partials, logscale, tp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  anti_alias_backward_sum<<<C, kSumThreads, 0, s>>>(part, af, bf, static_cast<float*>(grad_alpha),
                                                     static_cast<float*>(grad_beta), B, C, tiles,
                                                     n_partials, logscale);
  return static_cast<int>(cudaGetLastError());
}
