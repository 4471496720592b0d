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
// an element, against about 64 fp32 instructions and 4 MUFU an element; the
// bytes bound it (1.196 ms for the 334 M elements of a vocoder training step
// at batch 8 and 24 codes), with the instructions close behind, so the design
// spends none that is not that work.  It follows K1's (csrc/anti_alias.cu):
// - Register stencils.  A thread owns kV = 12 consecutive columns of a row
//   and the 12 pairs (u_e, u_o) at the same indices.  Its x and g windows
//   (3 columns each side) and its gu windows (3 pairs each side) come from
//   the neighbouring lanes by shuffles.  No shared memory, no barrier.
// - Segments.  The L lanes that walk one row together form a segment:
//   L = 32 where rows are long, 16 or 8 (two or four rows a warp) where a
//   row fits in 12 L columns, so the short rows of the first stages (T = 96:
//   L = 8, T = 384: L = 32 with one step a row) keep every lane busy.  The
//   shuffles take width L, so a segment's ends act as a warp's do.
// - Halo pairs only where a segment's neighbour in the row exists.  A
//   segment that holds a whole row needs none: the pairs outside a row are
//   0.  A segment of a long row computes the 3 pairs before its span and the
//   3 after it on lanes 0-2 and L-3..L-1, one each, from 7 columns of x and
//   g that only those lanes load (1 pair slot in 13 is halo work).
// - 16-byte loads and stores when a row starts 16-byte aligned (T % 4 == 0
//   and the three data pointers aligned); other rows take a scalar path of
//   the same kernel, chosen per call.  Each step's columns are loaded one
//   step ahead.
// - Long-lived segments.  The host (ops/cuda/anti_alias.py::backward_plan)
//   chooses the steps a segment takes so that the grid is about one wave at
//   every stage: consecutive 12 L-column chunks of one row (a piece), or,
//   where a row is one chunk, consecutive rows.  alpha, beta, exp and
//   1 / (beta + 1e-9) are taken once per row a segment visits.
// - Edges by correction: the clamps touch only ga_e[0], ga_o[T-1], grad_x[0]
//   and grad_x[T-1], which add fixed partial sums of the taps (host-computed)
//   times g or gu; only segments that touch a row's edge run them (a
//   segment-uniform branch).  Any T >= 1 is taken.
// - Deterministic per-channel sums: a segment sums its pairs' grad_alpha and
//   grad_beta terms in registers over all its steps in one row, reduces them
//   over its lanes in a fixed tree and writes one partial per (row, piece);
//   a second kernel (a programmatic dependent launch) sums a channel's
//   partials in a fixed order.  No float atomics: two runs are bit-equal.
// - One __sincosf a 2x-rate sample, of a u reduced modulo pi as K1 reduces
//   it: sin(2 a u) = 2 s c and sin^2(a u) = s s, which stays accurate where
//   a u is small (a quiet channel's grad_beta).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 12;
constexpr int kV = 12;                     // columns (and pairs) per thread
constexpr int kWin = kV + 6;               // window: columns (pairs) c-3 .. c+kV+2
constexpr int kWords = kV / 4;             // 16-byte words per thread
constexpr int kThreads = 64;               // two warps a block
constexpr int kSumThreads = 128;          // the sum kernel: 4 channels a block
constexpr unsigned kFull = 0xffffffffu;

constexpr float kPiHi = 3.140625f;                   // 201 / 64: 8 significant bits
constexpr float kPiLo = 9.67653589793e-4f;            // pi - kPiHi
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

// The per-row constants of the snake's derivative.
struct RowConst {
  float a, a_over_pi, a_over_b, inv_b;   // a, a / pi, a / b', 1 / b'
};

__device__ __forceinline__ RowConst row_const(const float* alpha, const float* beta, int ch,
                                              int logscale) {
  float a = alpha[ch];
  float b = beta[ch];
  if (logscale) {
    a = expf(a);
    b = expf(b);
  }
  RowConst k;
  k.inv_b = 1.0f / (b + 1e-9f);
  k.a = a;
  k.a_over_pi = a * kInvPi;
  k.a_over_b = a * k.inv_b;
  return k;
}

// A thread's kV columns of one array at one step: 16-byte words, or one by
// one; zeros past the row's end or where the slot is idle.
template <bool kVec>
struct Cols;

template <>
struct Cols<true> {
  float4 w[kWords];
  __device__ __forceinline__ void load(const float* r, int c, int T, bool on) {
    const float4* src = reinterpret_cast<const float4*>(r + c);
    if (on && c + kV <= T) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[k] = __ldg(src + k);
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        w[k] = on && c + 4 * (k + 1) <= T ? __ldg(src + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void to(float* out) const {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      out[4 * k] = w[k].x;
      out[4 * k + 1] = w[k].y;
      out[4 * k + 2] = w[k].z;
      out[4 * k + 3] = w[k].w;
    }
  }
};

template <>
struct Cols<false> {
  float v[kV];
  __device__ __forceinline__ void load(const float* r, int c, int T, bool on) {
    if (on && c + kV <= T) {
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = __ldg(r + c + i);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = on && c + i < T ? __ldg(r + c + i) : 0.f;
    }
  }
  __device__ __forceinline__ void to(float* out) const {
#pragma unroll
    for (int i = 0; i < kV; ++i) out[i] = v[i];
  }
};

// The 7 columns of x and g around a lane's halo pair nh (x clamped to the
// row, g zero outside it near an edge); lanes without a halo pair load none.
struct Halo {
  float x[7], g[7];
  __device__ __forceinline__ void load(const float* xr, const float* gr, int nh, bool on,
                                       bool edge, int T) {
    if (!on) {
#pragma unroll
      for (int i = 0; i < 7; ++i) x[i] = g[i] = 0.f;
    } else if (edge) {
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const int m = nh - 3 + i;
        x[i] = __ldg(xr + min(max(m, 0), T - 1));
        g[i] = m >= 0 && m < T ? __ldg(gr + m) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        x[i] = __ldg(xr + nh - 3 + i);
        g[i] = __ldg(gr + nh - 3 + i);
      }
    }
  }
};

// sin and cos of a u reduced modulo pi, as K1 reduces it: q = rint(a u / pi),
// r = a u - q pi in [-pi/2, pi/2] (pi = hi + lo, q hi exact for |q| < 2^16).
// Both carry the sign (-1)^q, which their products s c and s s drop.
__device__ __forceinline__ void sincos_reduced(float u, const RowConst& k, float* s, float* c) {
  const float q = fmaf(u, k.a_over_pi, kRound) - kRound;
  float r = u * k.a;
  r = fmaf(q, -kPiHi, r);
  r = fmaf(q, -kPiLo, r);
  __sincosf(r, s, c);
}

// u and ga of the pair whose 7-column windows of x and g start at xw, gw
// (the pair's own column at index 3).
__device__ __forceinline__ void pair_sums(const float* xw, const float* gw, const BwdTaps& tp,
                                          float& ue, float& uo, float& ae, float& ao) {
  ue = uo = ae = ao = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    ue = fmaf(tp.up[2 * j], xw[j], ue);
    uo = fmaf(tp.up[2 * j + 1], xw[j + 1], uo);
    ae = fmaf(tp.down[2 * j + 1], gw[5 - j], ae);
    ao = fmaf(tp.down[2 * j], gw[6 - j], ao);
  }
}

// gu of one 2x-rate sample, and its grad_alpha and grad_beta terms (before
// the row's 1/b' and -1/b'^2): sin(2 a u) = 2 s c, sin^2(a u) = s s.
__device__ __forceinline__ float snake_grad(float u, float ga, const RowConst& k, float& pa,
                                            float& pb) {
  float s, c;
  sincos_reduced(u, k, &s, &c);
  const float s2 = 2.f * s * c;
  pa = fmaf(ga * u, s2, pa);
  pb = fmaf(ga * s, s, pb);
  return ga * fmaf(k.a_over_b, s2, 1.f);
}

// The segment-wide sum of v, in a fixed tree; lane 0 of the segment holds it.
template <int kL>
__device__ __forceinline__ float segment_sum(float v) {
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off, kL);
  return v;
}

// One step of a segment: the gu of its lane's kV pairs and the grad_x of
// its kV columns (written where `act`), its grad_alpha and grad_beta terms
// added to pa and pb.  cx, cg: the lane's columns of x and g; h: its halo
// window (kPieces) around the pair w + halo_off; w: the chunk's first
// column; gxr: grad_x's row.  kEdge: the chunk or its halo touches a row's
// edge (segment-uniform), so the clamps and the edge corrections apply;
// the other steps, most of a long row's, run none of that code.
template <int kL, bool kVec, bool kPieces, bool kEdge>
__device__ __forceinline__ void backward_step(const Cols<kVec>& cx, const Cols<kVec>& cg,
                                              const Halo& h, const RowConst& k,
                                              const BwdTaps& tp, int lane, int halo_off,
                                              int w, int T, bool act, float* gxr, float& pa,
                                              float& pb) {
  const int c = w + lane * kV;   // this thread's first column
  // windows of x and g: xw[q], gw[q] at column c - 3 + q
  float xw[kWin], gw[kWin];
  cx.to(xw + 3);
  cg.to(gw + 3);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float xl = __shfl_up_sync(kFull, xw[kV + i], 1, kL);
    const float xr = __shfl_down_sync(kFull, xw[3 + i], 1, kL);
    const float gl = __shfl_up_sync(kFull, gw[kV + i], 1, kL);
    const float gr = __shfl_down_sync(kFull, gw[3 + i], 1, kL);
    // lane 0's columns w-3 .. w-1 and lane kL-1's w+span .. w+span+2: its
    // halo window (pairs w-3 and w+span+2); outside the row where a segment
    // holds whole rows
    xw[i] = lane == 0 ? (kPieces ? h.x[3 + i] : 0.f) : xl;
    gw[i] = lane == 0 ? (kPieces ? h.g[3 + i] : 0.f) : gl;
    xw[kV + 3 + i] = lane == kL - 1 ? (kPieces ? h.x[1 + i] : 0.f) : xr;
    gw[kV + 3 + i] = lane == kL - 1 ? (kPieces ? h.g[1 + i] : 0.f) : gr;
  }
  if (kEdge) {   // columns outside [0, T) read x[0] or x[T-1]; g is 0 there already
    if (c == 0) xw[0] = xw[1] = xw[2] = xw[3];
#pragma unroll
    for (int q = 1; q < kWin; ++q)
      if (c - 3 + q >= T) xw[q] = xw[q - 1];
  }

  // the halo lanes' gu pairs (w-3 .. w-1 on lanes 0-2, w+span .. w+span+2 on
  // lanes kL-3 .. kL-1; 0 where a segment holds whole rows)
  float ex_e = 0.f, ex_o = 0.f;
  if (kPieces) {
    const int n = w + halo_off;
    float ue, uo, ae, ao, ta = 0.f, tb = 0.f;
    pair_sums(h.x, h.g, tp, ue, uo, ae, ao);
    if (kEdge) {
      if (n == 0) ae += tp.gl[0] * h.g[3] + tp.gl[1] * h.g[4] + tp.gl[2] * h.g[5];
      if (n == T - 1) ao += tp.gr[0] * h.g[3] + tp.gr[1] * h.g[2] + tp.gr[2] * h.g[1];
      if (n < 0 || n >= T) ae = ao = 0.f;
    }
    ex_e = snake_grad(ue, ae, k, ta, tb);   // the owning segment counts its terms
    ex_o = snake_grad(uo, ao, k, ta, tb);
  }
  // gu windows: ge[p], go[p] at pair c - 3 + p (own pairs at 3 .. kV+2)
  float ge[kWin], go[kWin];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    float ue, uo, ae, ao;
    pair_sums(xw + i, gw + i, tp, ue, uo, ae, ao);
    if (kEdge) {
      if (c + i == 0) ae += tp.gl[0] * gw[3] + tp.gl[1] * gw[4] + tp.gl[2] * gw[5];
      if (c + i == T - 1) ao += tp.gr[0] * gw[i + 3] + tp.gr[1] * gw[i + 2] + tp.gr[2] * gw[i + 1];
      if (c + i >= T) ae = ao = 0.f;   // not a pair of the row: gu 0, no term
    }
    ge[3 + i] = snake_grad(ue, ae, k, pa, pb);
    go[3 + i] = snake_grad(uo, ao, k, pa, pb);
  }

  // gu halo: lane 0 takes pairs w-3 .. w-1 and lane kL-1 pairs w+span ..
  // w+span+2 from the halo lanes
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float lo = __shfl_up_sync(kFull, go[kV + i], 1, kL);
    const float ro = __shfl_down_sync(kFull, go[3 + i], 1, kL);
    const float le = __shfl_up_sync(kFull, ge[kV + i], 1, kL);
    const float re = __shfl_down_sync(kFull, ge[3 + i], 1, kL);
    float hlo = 0.f, hro = 0.f, hle = 0.f, hre = 0.f;
    if (kPieces) {
      hlo = __shfl_sync(kFull, ex_o, i, kL);
      hro = __shfl_sync(kFull, ex_o, kL - 3 + i, kL);
      hle = __shfl_sync(kFull, ex_e, i, kL);
      hre = __shfl_sync(kFull, ex_e, kL - 3 + i, kL);
    }
    go[i] = lane == 0 ? hlo : lo;
    ge[i] = lane == 0 ? hle : le;
    go[kV + 3 + i] = lane == kL - 1 ? hro : ro;
    ge[kV + 3 + i] = lane == kL - 1 ? hre : re;
  }

  // grad_x: column c + i reads gu_e at pairs c+i-2 .. c+i+3 (p = i+1 .. i+6)
  // and gu_o at c+i-3 .. c+i+2 (p = i .. i+5)
  float out[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc = fmaf(tp.up[2 * j], ge[i + 6 - j], acc);
      acc = fmaf(tp.up[2 * j + 1], go[i + 5 - j], acc);
    }
    out[i] = acc;
  }
  if (kEdge) {
    if (c == 0) {   // pairs n < 3 at p = n + 3; pairs past T-1 hold 0
#pragma unroll
      for (int n = 0; n < 3; ++n) out[0] = fmaf(tp.xle[n], ge[n + 3], out[0]);
#pragma unroll
      for (int n = 0; n < 2; ++n) out[0] = fmaf(tp.xlo[n], go[n + 3], out[0]);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (c + i == T - 1) {   // pair T-1-s at p = i + 3 - s; pairs below 0 hold 0
#pragma unroll
        for (int s = 0; s < 2; ++s) out[i] = fmaf(tp.xre[s], ge[i + 3 - s], out[i]);
#pragma unroll
        for (int s = 0; s < 3; ++s) out[i] = fmaf(tp.xro[s], go[i + 3 - s], out[i]);
      }
    }
  }
  if (act) {
    float* dst = gxr + c;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        if (!kEdge || c + 4 * (q + 1) <= T)
          reinterpret_cast<float4*>(dst)[q] =
              make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (!kEdge || c + i < T) dst[i] = out[i];
    }
  }
}

// kL lanes a segment; kPieces: segments walk consecutive chunks of one row
// (rows longer than 12 kL), else consecutive whole rows.
template <int kL, bool kVec, bool kPieces>
__global__ void __launch_bounds__(kThreads)
anti_alias_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ alpha, const float* __restrict__ beta,
                           float* __restrict__ gx, float* __restrict__ partial, int C, int T,
                           int rows, int steps, int pieces, int segments,
                           long long n_partials, int logscale, BwdTaps tp) {
  // let the sum kernel's launch begin; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  constexpr int kSpan = kL * kV;   // columns a segment covers a step
  const int lane = threadIdx.x % kL;
  const int seg = blockIdx.x * (kThreads / kL) + threadIdx.x / kL;
  const int chunks = (T + kSpan - 1) / kSpan;

  // this segment's first row and chunk, and its steps
  int row0, chunk0, n_steps;
  if (kPieces) {
    row0 = seg / pieces;
    chunk0 = (seg - row0 * pieces) * steps;
    n_steps = min(steps, chunks - chunk0);
  } else {
    row0 = seg * steps;
    chunk0 = 0;
    n_steps = min(steps, rows - row0);
  }
  if (seg >= segments) n_steps = 0;
  // a halo lane's pair, relative to the chunk's first column
  const int halo_off = lane < 3 ? lane - 3 : lane >= kL - 3 ? kSpan + lane - (kL - 3) : 0;
  const bool halo_lane = kPieces && (lane < 3 || lane >= kL - 3);

  // a segment of a long row stays in row0; one of whole rows moves on a row
  // a step (rows past the last are read as the last and never written)
  auto row_at = [&](int t) { return (long long)min(kPieces ? row0 : row0 + t, rows - 1) * T; };
  auto edge_at = [&](int w) { return w == 0 || w + kSpan + 6 > T; };   // segment-uniform

  Cols<kVec> cx, cg;   // this step's columns; the next step's are loaded while it computes
  Halo h;
  {
    const long long base = row_at(0);
    const int w = chunk0 * kSpan;
    const bool on = n_steps > 0;
    cx.load(x + base, w + lane * kV, T, on);
    cg.load(g + base, w + lane * kV, T, on);
    if (kPieces) h.load(x + base, g + base, w + halo_off, on && halo_lane, edge_at(w), T);
  }
  RowConst k = {1.f, 0.f, 0.f, 1.f};
  if (kPieces && n_steps > 0) k = row_const(alpha, beta, row0 % C, logscale);
  float pa = 0.f, pb = 0.f;

  for (int t = 0; t < steps; ++t) {
    const bool act = t < n_steps;
    if (!__any_sync(kFull, act)) break;
    const int row = kPieces ? row0 : row0 + t;
    const int w = (kPieces ? chunk0 + t : 0) * kSpan;
    const long long base = row_at(t);
    if (!kPieces && act) k = row_const(alpha, beta, row % C, logscale);
    const bool edge = edge_at(w);

    Cols<kVec> nx, ng;
    Halo nh;
    {
      const bool on = t + 1 < n_steps;
      const long long base1 = row_at(t + 1);
      const int w1 = kPieces ? w + kSpan : 0;
      nx.load(x + base1, w1 + lane * kV, T, on);
      ng.load(g + base1, w1 + lane * kV, T, on);
      if (kPieces) nh.load(x + base1, g + base1, w1 + halo_off, on && halo_lane, edge_at(w1), T);
    }

    float* gxr = gx + base;
    if (!kPieces || edge)   // a segment of whole rows always touches both edges
      backward_step<kL, kVec, kPieces, true>(cx, cg, h, k, tp, lane, halo_off, w, T, act, gxr,
                                             pa, pb);
    else
      backward_step<kL, kVec, kPieces, false>(cx, cg, h, k, tp, lane, halo_off, w, T, act, gxr,
                                              pa, pb);

    // one partial per (row, piece): after each row where a segment holds whole
    // rows, after its last step in the row otherwise (segment-uniform)
    if (!kPieces || t == n_steps - 1) {
      const float sa = segment_sum<kL>(pa * k.inv_b);
      const float sb = segment_sum<kL>(pb * (-k.inv_b * k.inv_b));
      if (act && lane == 0) {
        const long long idx = kPieces ? (long long)seg : (long long)row;
        partial[idx] = sa;
        partial[n_partials + idx] = sb;
      }
      pa = pb = 0.f;
    }
    cx = nx;
    cg = ng;
    h = nh;
  }
}

// One warp a channel: the partials of rows (b, ch) for b < B, pieces in
// order, summed by each lane over a fixed stride and then in a fixed tree.
__global__ void __launch_bounds__(kSumThreads)
anti_alias_backward_sum(const float* __restrict__ partial, const float* __restrict__ alpha,
                        const float* __restrict__ beta, float* __restrict__ grad_ab, int B,
                        int C, int pieces, long long n_partials, int logscale) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int ch = blockIdx.x * (kSumThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ch >= C) return;   // warp-uniform
  const long long per_ch = (long long)B * pieces;
  float sa = 0.f, sb = 0.f;
  for (long long i = lane; i < per_ch; i += 32) {
    const long long b = i / pieces;
    const long long idx = (b * C + ch) * pieces + (i - b * pieces);
    sa += partial[idx];
    sb += partial[n_partials + idx];
  }
  sa = segment_sum<32>(sa);
  sb = segment_sum<32>(sb);
  if (lane == 0) {
    if (logscale) {
      sa *= expf(alpha[ch]);
      sb *= expf(beta[ch]);
    }
    grad_ab[ch] = sa;
    grad_ab[C + ch] = sb;
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*, float*,
                          int, int, int, int, int, int, long long, int, BwdTaps);

template <bool kVec>
KernelFn pick(int seg_lanes, int multi_row) {
  if (!multi_row) {
    if (seg_lanes != 32) return nullptr;
    return anti_alias_backward_kernel<32, kVec, true>;
  }
  switch (seg_lanes) {
    case 8: return anti_alias_backward_kernel<8, kVec, false>;
    case 16: return anti_alias_backward_kernel<16, kVec, false>;
    case 32: return anti_alias_backward_kernel<32, kVec, false>;
    default: return nullptr;
  }
}

KernelFn pick(int seg_lanes, int vec, int multi_row) {
  return vec ? pick<true>(seg_lanes, multi_row) : pick<false>(seg_lanes, multi_row);
}

}  // namespace

// The main kernel's constants, for the host's plan: out = {columns per
// thread, threads per block}.
extern "C" int anti_alias_backward_layout(long long* out) {
  out[0] = kV;
  out[1] = kThreads;
  return 0;
}

// Blocks of the main kernel's variant (segment lanes, 16-byte path, whole
// rows a segment) that one SM holds at once, or a negative CUDA error.
extern "C" int anti_alias_backward_resident(int seg_lanes, int vec, int multi_row) {
  const KernelFn fn = pick(seg_lanes, vec, multi_row);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, 0);
  return rc != cudaSuccess ? -static_cast<int>(rc) : n;
}

// One call's shape and plan, filled by the host (ops/cuda/anti_alias.py::
// _Launch mirrors it): the plan is backward_plan's.
struct BackwardLaunch {
  int B, C, T, logscale;
  int seg_lanes;   // 8, 16 or 32
  int vec;         // the 16-byte path
  int multi_row;   // a segment takes whole rows
  int steps, pieces, segments, blocks;
  float taps[kTaps];
};

// x, g, gx: [B, C, T] fp32 contiguous; alpha, beta: [C] fp32; grad_ab:
// 2 C + 2 B C pieces floats: grad_alpha, grad_beta, then the partials.
// Launches two kernels on `stream` (the second a programmatic dependent
// launch) and returns the first CUDA error, or cudaErrorInvalidValue for a
// plan that does not cover the input.
extern "C" int anti_alias_backward_launch(const void* x, const void* alpha, const void* beta,
                                          const void* g, void* gx, void* grad_ab,
                                          const BackwardLaunch* p, void* stream) {
  const int B = p->B, C = p->C, T = p->T, steps = p->steps, pieces = p->pieces;
  const int segments = p->segments, blocks = p->blocks, seg_lanes = p->seg_lanes;
  const int multi_row = p->multi_row, vec = p->vec, logscale = p->logscale;
  const float* taps = p->taps;
  const long long rows = (long long)B * C;
  const int span = seg_lanes * kV;
  const long long chunks = (T + (long long)span - 1) / span;
  const KernelFn fn = pick(seg_lanes, vec, multi_row);
  const bool covers =
      fn != nullptr && B > 0 && C > 0 && T > 0 && steps > 0 && pieces > 0 && blocks > 0 &&
      (long long)blocks * (kThreads / seg_lanes) >= segments &&
      (multi_row ? chunks == 1 && pieces == 1 && (long long)segments * steps >= rows
                 : chunks > 1 && (long long)pieces * steps >= chunks &&
                       (long long)segments == rows * pieces);
  const bool aligned = T % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(gx) % 16 == 0);
  if (!covers || (vec && !aligned) || rows * T >= (1LL << 62))
    return static_cast<int>(cudaErrorInvalidValue);
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
  const long long n_partials = rows * pieces;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(alpha);
  const auto* bf = static_cast<const float*>(beta);
  auto* part = static_cast<float*>(grad_ab) + 2 * C;
  fn<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(g), af,
                                  bf, static_cast<float*>(gx), part, C, T, (int)rows, steps,
                                  pieces, segments, n_partials, logscale, tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + kSumThreads / 32 - 1) / (kSumThreads / 32));
  cfg.blockDim = dim3(kSumThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, anti_alias_backward_sum, static_cast<const float*>(part), af, bf,
                           static_cast<float*>(grad_ab), B, C, pieces, n_partials, logscale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
