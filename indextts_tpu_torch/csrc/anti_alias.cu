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
// For 3 <= t <= T-4 the clamp never bites and y[t] reduces to the two 6-tap
// sums sum_j f[2j] a_o[t+j-3] + f[2j+1] a_e[t+j-2]; the first and last three
// outputs clamp the *activated* 2x-rate signal across parity, so they take
// the general 12-tap form.
//
// Bound on the H100: each element is read once and written once (4 bytes in
// bf16, 8 in fp32) against about 56 fp32 operations and 2 sinf, so device
// memory bandwidth bounds it.  Design: one block per (batch, channel, tile of
// 1024 outputs); the tile and a clamped halo of 6 input columns each side are
// staged once in shared memory, a_e/a_o for the tile (+3 each side) are
// computed there in fp32, and each output is written once.  All math is
// fp32; bf16 or fp32 come in and go out.  Any T >= 1 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 12;
constexpr int kTile = 1024;   // outputs per block
constexpr int kThreads = 256;
constexpr int kHalo = 6;      // input columns each side of the tile

struct Taps {
  float f[kTaps];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
anti_alias_kernel(const T* __restrict__ x, const T* __restrict__ alpha,
                  const T* __restrict__ beta, T* __restrict__ y, int C, int T_len,
                  int logscale, Taps taps) {
  __shared__ float xs[kTile + 2 * kHalo];  // xs[i] = x[clamp(g - 6 + i)]
  __shared__ float ae[kTile + kHalo];      // ae[i] = a_e[g - 3 + i]
  __shared__ float ao[kTile + kHalo];      // ao[i] = a_o[g - 3 + i]

  const int g = blockIdx.x * kTile;
  const int c = blockIdx.y;
  const long long row = ((long long)blockIdx.z * C + c) * T_len;
  const T* xr = x + row;
  T* yr = y + row;

  float a = to_f32(alpha[c]);
  float b = to_f32(beta[c]);
  if (logscale) {
    a = expf(a);
    b = expf(b);
  }
  const float inv_b = 1.0f / (b + 1e-9f);

  for (int i = threadIdx.x; i < kTile + 2 * kHalo; i += kThreads) {
    const int n = min(max(g - kHalo + i, 0), T_len - 1);
    xs[i] = to_f32(xr[n]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile + kHalo; i += kThreads) {
    float ue = 0.f, uo = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      ue = fmaf(taps.f[2 * j], xs[i + j], ue);
      uo = fmaf(taps.f[2 * j + 1], xs[i + j + 1], uo);
    }
    ue *= 2.f;
    uo *= 2.f;
    const float se = sinf(ue * a);
    const float so = sinf(uo * a);
    ae[i] = ue + inv_b * se * se;
    ao[i] = uo + inv_b * so * so;
  }
  __syncthreads();

  for (int tl = threadIdx.x; tl < kTile; tl += kThreads) {
    const int t = g + tl;
    if (t >= T_len) break;
    float acc = 0.f;
    if (t >= 3 && t <= T_len - 4) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        acc = fmaf(taps.f[2 * j], ao[tl + j], acc);
        acc = fmaf(taps.f[2 * j + 1], ae[tl + j + 1], acc);
      }
    } else {
      for (int k = 0; k < kTaps; ++k) {
        const int m = min(max(2 * t + k - 5, 0), 2 * T_len - 1);
        const int i = (m >> 1) - g + 3;
        acc = fmaf(taps.f[k], (m & 1) ? ao[i] : ae[i], acc);
      }
    }
    store(yr + t, acc);
  }
}

}  // namespace

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: [B, C, T] contiguous; alpha, beta: [C], all of one type (bf16 when
// is_bf16, else fp32).  taps: the 12 filter taps, host memory.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int anti_alias_activation(const void* x, const void* alpha, const void* beta,
                                     void* y, int B, int C, int T, int is_bf16,
                                     int logscale, const float* taps, void* stream) {
  Taps tp;
  for (int k = 0; k < kTaps; ++k) tp.f[k] = taps[k];
  const dim3 grid((T + kTile - 1) / kTile, C, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    anti_alias_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(alpha),
        static_cast<const __nv_bfloat16*>(beta), static_cast<__nv_bfloat16*>(y), C, T,
        logscale, tp);
  } else {
    anti_alias_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(alpha),
        static_cast<const float*>(beta), static_cast<float*>(y), C, T, logscale, tp);
  }
  return static_cast<int>(cudaGetLastError());
}
