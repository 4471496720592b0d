// Fused anti-aliased SnakeBeta activation for Hopper (sm_90a).
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/anti_alias.py
// (fused_anti_alias_activation, :242; body _kernel, :112).  It computes
// down2(snakebeta(up2(x))) for x [B, C, T] with the 12-tap kaiser-sinc filter
// f (cutoff 0.25, half-width 0.3) and replicate padding, without writing the
// 2x-rate signal to device memory.  In polyphase form, with x indices clamped
// to [0, T-1]:
//
//   u_e[n] = 2 sum_j f[2j]   x[n+j-3]      a_e = snake(u_e)
//   u_o[n] = 2 sum_j f[2j+1] x[n+j-2]      a_o = snake(u_o)
//   y[t]   = sum_k f[k] A[clamp(2t+k-5, 0, 2T-1)],  A[2n] = a_e[n], A[2n+1] = a_o[n]
//
// Without the clamp, y[t] is the two 6-tap sums
// sum_j f[2j] a_o[t+j-3] + f[2j+1] a_e[t+j-2].  The clamp bites only for the
// first and last three outputs, and only on the *activated* 2x-rate signal,
// across parity: A below 0 reads a_e[0], A above 2T-1 reads a_o[T-1].  So a
// thread near a row's edge replaces the pairs (a_e[n], a_o[n]) of its window
// with n < 0 by a_e[0] and those with n >= T by a_o[T-1] (and its x columns
// outside [0, T) by x[0] or x[T-1]), and then every output takes the same
// two 6-tap sums: no clamp and no branch per tap anywhere.
//
// Bound on the H100: each element is read once and written once (4 bytes in
// bf16, 8 in fp32) against 24 FMAs and two sines per output.  The bytes bound
// it on paper (0.53 ms per 256-code vocode in bf16), but the instructions
// that the work takes, about 42 per output in fp32, are a floor of about the
// same size, so the design cuts every instruction that is not that work:
// - Register stencils.  A thread owns kV consecutive outputs of a row and the
//   kV pairs of the same columns, all in registers.  Its x window (kV + 6
//   columns) and pair window (kV + 6 pairs) take their 3 + 3 halo columns from
//   the neighbouring lanes by warp shuffles.  At a warp's two ends, lanes 0-2
//   and 29-31 compute the 6 halo pairs that no lane of the warp owns, one
//   each (all 32 lanes run that slot: 1 in kV + 1 pair slots is halo work).
//   No shared memory, no block-wide barrier.
// - One hardware transcendental per 2x-rate sample.  sin^2 has period pi:
//   theta = a u is reduced by k = rint(theta / pi) with pi split into
//   hi + lo (k pi_hi is exact for |k| < 2^16), and __sinf (MUFU.SIN, absolute
//   error below 2^-21.4 on [-pi, pi]) takes the remainder in [-pi/2, pi/2].
//   This holds while |theta| < 2^22 (the rounding constant's range).  8 fp32
//   instructions and one MUFU a sample, and no slow path: libdevice's sinf
//   keeps one for large arguments, with a call and a stack frame.
// - 16-byte loads and stores when a row starts 16-byte aligned (bf16: T % 8
//   == 0, fp32: T % 4 == 0, and both data pointers aligned); other rows take
//   a scalar path of the same kernel, chosen per call.  Each step's columns
//   and halo x are loaded one step ahead.
// - A block of kWarps warps covers kBlockSpan consecutive outputs of one row
//   a step and takes `steps` steps; the host sizes `steps` from (B, C, T) and
//   the card's resident blocks, so that the grid is about one wave at every
//   stage of the vocoder.
// - Only warps that touch a row's edge run the replacements above (a
//   warp-uniform branch); the others take the two 6-tap sums directly.
// alpha, beta, exp and 1 / (beta + 1e-9) are taken once per block.  All math
// is fp32; bf16 or fp32 come in and go out.  Any T >= 1 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 12;
constexpr int kV = 24;                      // outputs (and pairs) per thread
constexpr int kWin = kV + 6;                // window columns c-3 .. c+kV+2
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpSpan = 32 * kV;          // outputs per warp a step
constexpr int kBlockSpan = kThreads * kV;   // outputs per block a step
constexpr unsigned kFull = 0xffffffffu;

constexpr float kPiHi = 3.140625f;                // 201 / 64: 8 significant bits
constexpr float kPiLo = 9.67653589793e-4f;        // pi - kPiHi
constexpr float kInvPi = 0.318309886183791f;
constexpr float kRound = 12582912.0f;             // 1.5 * 2^23: (v + kRound) - kRound = rint(v)

struct Taps {
  float up[kTaps];    // 2 f: the upsampler's gain folded in (exact)
  float down[kTaps];  // f
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The elements a thread owns, as 16-byte words (kVec) or one by one.
template <typename T>
struct Words {
  static constexpr int kPer = 16 / sizeof(T);   // elements per 16-byte word
  static constexpr int kN = kV / kPer;          // words per thread
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float* out);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& w, float* out) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& w, float* out) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(v[i] << 16);
    out[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v);

template <>
__device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// u + (1/b) sin^2(a u), with sin^2 taken on the remainder of a u modulo pi.
__device__ __forceinline__ float snake(float u, float a, float a_over_pi, float inv_b) {
  const float theta = u * a;
  const float k = fmaf(u, a_over_pi, kRound) - kRound;
  float r = fmaf(k, -kPiHi, theta);
  r = fmaf(k, -kPiLo, r);
  const float s = __sinf(r);
  return fmaf(s * inv_b, s, u);
}

// The elements a thread owns at one step, as loaded: 16-byte words, or one
// by one (zeros past the row's end).
template <typename T, bool kVec>
struct Own;

template <typename T>
struct Own<T, true> {
  uint4 w[Words<T>::kN];
  __device__ __forceinline__ void load(const T* xr, int c, int T_len) {
    const uint4* src = reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int k = 0; k < Words<T>::kN; ++k)
      w[k] = c + (k + 1) * Words<T>::kPer <= T_len ? __ldg(src + k) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void unpack_to(float* out) const {
#pragma unroll
    for (int k = 0; k < Words<T>::kN; ++k) unpack<T>(w[k], out + k * Words<T>::kPer);
  }
};

template <typename T>
struct Own<T, false> {
  T v[kV];
  __device__ __forceinline__ void load(const T* xr, int c, int T_len) {
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = c + i < T_len ? xr[c + i] : T(0.f);
  }
  __device__ __forceinline__ void unpack_to(float* out) const {
#pragma unroll
    for (int i = 0; i < kV; ++i) out[i] = to_f32(v[i]);
  }
};

// The 7 x columns of a lane's halo pair at the step that starts at column
// w (lanes 0-2: the pairs w-3 .. w-1, lanes 29-31: the pairs after the warp's
// span; the other lanes' are unused), clamped to the row where the warp is
// near one of its edges.
template <typename T>
__device__ __forceinline__ void load_halo(T (&xe)[7], const T* xr, int w, int lane, int T_len) {
  const int n = lane < 3 ? w - 3 + lane : lane >= 29 ? w + kWarpSpan + lane - 29 : w + lane * kV;
  if (w == 0 || w + kWarpSpan + 6 > T_len) {   // warp-uniform
#pragma unroll
    for (int i = 0; i < 7; ++i) xe[i] = xr[min(max(n - 3 + i, 0), T_len - 1)];
  } else {
    const T* p = xr + (n - 3);
#pragma unroll
    for (int i = 0; i < 7; ++i) xe[i] = p[i];
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
anti_alias_kernel(const T* __restrict__ x, const T* __restrict__ alpha,
                  const T* __restrict__ beta, T* __restrict__ y, int C, int T_len,
                  int blocks_per_row, int steps, int logscale, Taps taps) {
  const int row = blockIdx.x / blocks_per_row;
  const int run = blockIdx.x - row * blocks_per_row;
  const int ch = row % C;
  const long long base = (long long)row * T_len;
  const T* xr = x + base;
  T* yr = y + base;

  float a = to_f32(alpha[ch]);
  float b = to_f32(beta[ch]);
  if (logscale) {
    a = expf(a);
    b = expf(b);
  }
  const float inv_b = 1.0f / (b + 1e-9f);
  const float a_over_pi = a * kInvPi;

  const int lane = threadIdx.x & 31;
  const int start = run * steps * kBlockSpan + (threadIdx.x >> 5) * kWarpSpan;
  const int stop = min(T_len, (run + 1) * steps * kBlockSpan);

  Own<T, kVec> own;   // this step's columns and halo x; the next step's are loaded
  T xe_own[7];         // while this one computes
  if (start < stop) {
    own.load(xr, start + lane * kV, T_len);
    load_halo(xe_own, xr, start, lane, T_len);
  }
  for (int w = start; w < stop; w += kBlockSpan) {   // warp-uniform
    const int c = w + lane * kV;                       // this thread's first column
    Own<T, kVec> next;
    T xe_next[7];
    if (w + kBlockSpan < stop) {
      next.load(xr, c + kBlockSpan, T_len);
      load_halo(xe_next, xr, w + kBlockSpan, lane, T_len);
    }

    // One halo pair a lane: lanes 0-2 the three pairs before column w, lanes
    // 29-31 the three after the warp's span.  xe: its 7 x columns; lane 0
    // reads its x halo x[w-3 .. w-1] there, lane 31 its x[w+span .. w+span+2].
    float xe[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) xe[i] = to_f32(xe_own[i]);

    // x window: xw[q] = x[c - 3 + q]
    float xw[kWin];
    own.unpack_to(xw + 3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float l = __shfl_up_sync(kFull, xw[kV + i], 1);
      const float r = __shfl_down_sync(kFull, xw[3 + i], 1);
      xw[i] = lane == 0 ? xe[3 + i] : l;
      xw[3 + kV + i] = lane == 31 ? xe[1 + i] : r;
    }
    const bool edge_warp = w == 0 || w + kWarpSpan + 3 > T_len;
    if (edge_warp) {   // columns outside [0, T) read x[0] or x[T-1]
      if (c == 0) xw[0] = xw[1] = xw[2] = xw[3];
#pragma unroll
      for (int q = 1; q < kWin; ++q)
        if (c - 3 + q >= T_len) xw[q] = xw[q - 1];
    }

    // pair window: ae[p], ao[p] = a_e, a_o at column c - 3 + p
    float ae[kWin], ao[kWin];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float ue = 0.f, uo = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        ue = fmaf(taps.up[2 * j], xw[i + j], ue);
        uo = fmaf(taps.up[2 * j + 1], xw[i + j + 1], uo);
      }
      ae[3 + i] = snake(ue, a, a_over_pi, inv_b);
      ao[3 + i] = snake(uo, a, a_over_pi, inv_b);
    }
    float ex_e, ex_o;
    {
      float ue = 0.f, uo = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        ue = fmaf(taps.up[2 * j], xe[j], ue);
        uo = fmaf(taps.up[2 * j + 1], xe[j + 1], uo);
      }
      ex_e = snake(ue, a, a_over_pi, inv_b);
      ex_o = snake(uo, a, a_over_pi, inv_b);
    }

    // halo pairs from the neighbouring lanes (the down filter reads ao[0..kV+4]
    // and ae[1..kV+5]); lanes 0 and 31 take the warp's own halo pairs
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float lo = __shfl_up_sync(kFull, ao[kV + i], 1);
      const float ro = __shfl_down_sync(kFull, ao[3 + i], 1);
      const float elo = __shfl_sync(kFull, ex_o, i);
      const float ero = __shfl_sync(kFull, ex_o, 29 + i);
      ao[i] = lane == 0 ? elo : lo;
      if (i < 2) ao[3 + kV + i] = lane == 31 ? ero : ro;
      const float re = __shfl_down_sync(kFull, ae[3 + i], 1);
      const float ere = __shfl_sync(kFull, ex_e, 29 + i);
      ae[3 + kV + i] = lane == 31 ? ere : re;
      if (i > 0) {
        const float le = __shfl_up_sync(kFull, ae[kV + i], 1);
        const float ele = __shfl_sync(kFull, ex_e, i);
        ae[i] = lane == 0 ? ele : le;
      }
    }
    if (edge_warp) {   // the clamp of the activated signal: A[< 0] = a_e[0], A[> 2T-1] = a_o[T-1]
      if (c == 0) ae[1] = ae[2] = ao[0] = ao[1] = ao[2] = ae[3];
#pragma unroll
      for (int p = 1; p < kWin; ++p) {
        if (c - 3 + p >= T_len) {
          ae[p] = ao[p - 1];
          ao[p] = ao[p - 1];
        }
      }
    }

    float out[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        acc = fmaf(taps.down[2 * j], ao[i + j], acc);
        acc = fmaf(taps.down[2 * j + 1], ae[i + j + 1], acc);
      }
      out[i] = acc;
    }
    if (kVec) {
      uint4* dst = reinterpret_cast<uint4*>(yr + c);
#pragma unroll
      for (int k = 0; k < Words<T>::kN; ++k)
        if (c + (k + 1) * Words<T>::kPer <= T_len) dst[k] = pack<T>(out + k * Words<T>::kPer);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (c + i < T_len) store_one(yr + c + i, out[i]);
    }
    own = next;
#pragma unroll
    for (int i = 0; i < 7; ++i) xe_own[i] = xe_next[i];
  }
}

struct Plan {
  int vec;             // 16-byte path
  int blocks_per_row;
  int steps;           // kBlockSpan-output steps per block
  long long blocks;
};

template <typename T, bool kVec>
int resident_blocks() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, anti_alias_kernel<T, kVec>, kThreads, 0);
  return n > 0 ? n : 1;
}

// Blocks of this kernel the card holds at once: SMs x resident blocks per SM,
// read once per (device, instantiation).
int capacity(int is_bf16, int vec) {
  static int cache[16][4];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) dev = 0;
  int& slot = cache[dev][2 * is_bf16 + vec];
  if (slot == 0) {
    int n_sm = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const int per_sm = is_bf16 ? (vec ? resident_blocks<__nv_bfloat16, true>()
                                      : resident_blocks<__nv_bfloat16, false>())
                               : (vec ? resident_blocks<float, true>()
                                      : resident_blocks<float, false>());
    slot = (n_sm > 0 ? n_sm : 1) * per_sm;
  }
  return slot;
}

// Steps per block: the fewest that keep the grid within one wave of resident
// blocks.
Plan make_plan(int B, int C, int T, int is_bf16, int vec) {
  Plan p;
  p.vec = vec;
  const long long rows = (long long)B * C;
  const long long chunks = (T + kBlockSpan - 1) / kBlockSpan;
  const long long cap = capacity(is_bf16, vec);
  p.steps = (int)((rows * chunks + cap - 1) / cap);
  if (p.steps < 1) p.steps = 1;
  if (p.steps > chunks) p.steps = (int)chunks;
  p.blocks_per_row = (int)((chunks + p.steps - 1) / p.steps);
  p.blocks = rows * p.blocks_per_row;
  return p;
}

}  // namespace

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch that anti_alias_activation makes for these arguments, with rows
// 16-byte aligned when `aligned`: out = {16-byte path, outputs per thread,
// threads per block, outputs per block step, steps per block, blocks}.
extern "C" int anti_alias_plan(int B, int C, int T, int is_bf16, int aligned, long long* out) {
  const int per = is_bf16 ? 8 : 4;
  const Plan p = make_plan(B, C, T, is_bf16, aligned && T % per == 0);
  out[0] = p.vec;
  out[1] = kV;
  out[2] = kThreads;
  out[3] = kBlockSpan;
  out[4] = p.steps;
  out[5] = p.blocks;
  return static_cast<int>(cudaGetLastError());
}

// x, y: [B, C, T] contiguous; alpha, beta: [C], all of one type (bf16 when
// is_bf16, else fp32).  taps: the 12 filter taps, host memory.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int anti_alias_activation(const void* x, const void* alpha, const void* beta,
                                     void* y, int B, int C, int T, int is_bf16,
                                     int logscale, const float* taps, void* stream) {
  Taps tp;
  for (int k = 0; k < kTaps; ++k) {
    tp.up[k] = 2.f * taps[k];
    tp.down[k] = taps[k];
  }
  const int per = is_bf16 ? 8 : 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const Plan p = make_plan(B, C, T, is_bf16, aligned && T % per == 0);
  if (p.blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(p.blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* ab = static_cast<const __nv_bfloat16*>(alpha);
  const auto* bb = static_cast<const __nv_bfloat16*>(beta);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const auto* xf = static_cast<const float*>(x);
  const auto* af = static_cast<const float*>(alpha);
  const auto* bf = static_cast<const float*>(beta);
  auto* yf = static_cast<float*>(y);
  if (is_bf16 && p.vec)
    anti_alias_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(
        xb, ab, bb, yb, C, T, p.blocks_per_row, p.steps, logscale, tp);
  else if (is_bf16)
    anti_alias_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
        xb, ab, bb, yb, C, T, p.blocks_per_row, p.steps, logscale, tp);
  else if (p.vec)
    anti_alias_kernel<float, true><<<grid, kThreads, 0, s>>>(
        xf, af, bf, yf, C, T, p.blocks_per_row, p.steps, logscale, tp);
  else
    anti_alias_kernel<float, false><<<grid, kThreads, 0, s>>>(
        xf, af, bf, yf, C, T, p.blocks_per_row, p.steps, logscale, tp);
  return static_cast<int>(cudaGetLastError());
}
