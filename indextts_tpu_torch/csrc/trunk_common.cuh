// Device helpers shared by the decode-trunk kernels for Hopper (sm_90a):
// decode_layer.cu (one row) and pool_trunk.cu (S pool rows).
//
// Types: the activation type A is bf16 or fp32; the cache type C is A or fp8
// e4m3.  fp8 conversion rounds to nearest even, as torch's float8_e4m3fn cast
// and the JAX package's; a magnitude of 480 or more (and NaN) becomes NaN, no
// saturation (CUDA's __NV_SATFINITE would clamp at 448).
//
// Attention over one row's cache: one block per (head, 64-slot chunk of
// [0, pos]), four warps of 16 slots, each chunk's softmax written as {max,
// sum, acc[hd]} and combined across chunks by a second kernel.  The token's
// own slot pos is read from the fp32 qkv rounded to A (the TPU kernels merge
// the new row into their chunk in the compute type); slots before pos come
// from the cache.  The mask is additive (-1e9 where it is 0): a row whose
// mask is all zero averages its slots and stays finite.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kAttnChunk = 64;  // cache slots per attention block
constexpr int kAttnWarps = 4;
constexpr int kSlotsPerWarp = kAttnChunk / kAttnWarps;
constexpr float kNegInf = -1e9f;

enum Epilogue { kStore = 0, kStoreGelu = 1, kAddTo = 2 };
enum WeightForm { kPlain = 0, kInt8 = 1, kInt4 = 2 };

struct fp8_e4m3 {
  uint8_t bits;
};

__device__ __forceinline__ float e4m3_to_f32(uint8_t v) {
  const uint32_t sign = static_cast<uint32_t>(v & 0x80) << 24;
  const uint32_t e = (v >> 3) & 0xF, m = v & 7;
  if (e == 15 && m == 7) return __uint_as_float(sign | 0x7FC00000u);  // NaN
  if (e == 0) {                                                       // subnormal
    const float r = static_cast<float>(m) * 0.001953125f;             // m * 2^-9
    return sign ? -r : r;
  }
  return __uint_as_float(sign | ((e + 120) << 23) | (m << 20));
}

__device__ __forceinline__ uint8_t f32_to_e4m3(float f) {
  uint32_t bits = __float_as_uint(f);
  const uint8_t sign = static_cast<uint8_t>((bits >> 24) & 0x80);
  bits &= 0x7FFFFFFFu;
  if (bits >= (1087u << 20)) return sign | 0x7F;  // |f| >= 480, inf or NaN: NaN
  if (bits < (121u << 23)) {                      // below 2^-6: subnormal (or 0)
    const uint32_t magic = 141u << 23;            // adding it rounds to even at 2^-9
    const uint32_t r = __float_as_uint(__uint_as_float(bits) + __uint_as_float(magic));
    return sign | static_cast<uint8_t>(r - magic);
  }
  const uint32_t mant_odd = (bits >> 20) & 1;
  bits += (static_cast<uint32_t>(7 - 127) << 23) + 0x7FFFF + mant_odd;
  return sign | static_cast<uint8_t>(bits >> 20);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(fp8_e4m3 v) { return e4m3_to_f32(v.bits); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(fp8_e4m3* p, float v) { p->bits = f32_to_e4m3(v); }

// v rounded to type T and back
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const fp8_e4m3* p) {
  const uint16_t two = *reinterpret_cast<const uint16_t*>(p);
  return make_float2(e4m3_to_f32(two & 0xFF), e4m3_to_f32(two >> 8));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_new(float h) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
}

// One attention block (kAttnWarps * 32 threads) for head h and slot chunk
// `chunk` of one row: q, k_new, v_new are this step's fp32 rows (length D,
// head-major), kc / vc the row's cache [T, D], mask [T].  Writes out[0] =
// max, out[1] = sum, out[2 + d] = acc[d] of the chunk's softmax.
template <typename A, typename C>
__device__ __forceinline__ void attn_partial_block(const float* __restrict__ q,
                                                   const float* __restrict__ k_new,
                                                   const float* __restrict__ v_new,
                                                   const C* __restrict__ kc,
                                                   const C* __restrict__ vc,
                                                   const int* __restrict__ mask, int pos,
                                                   int D, float scale, int h, int chunk,
                                                   float* __restrict__ out) {
  __shared__ float wm[kAttnWarps], ws[kAttnWarps], wacc[kAttnWarps][kHeadDim];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = h * kHeadDim + 2 * lane;
  const float q0 = q[col], q1 = q[col + 1];
  const int base = chunk * kAttnChunk + warp * kSlotsPerWarp;

  float sc[kSlotsPerWarp];
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) {
    const int t = base + i;
    float d = 0.f;
    if (t < pos) {
      const float2 kv = load2(kc + (long long)t * D + col);
      d = q0 * kv.x + q1 * kv.y;
    } else if (t == pos) {
      d = q0 * round_to<A>(k_new[col]) + q1 * round_to<A>(k_new[col + 1]);
    }
    sc[i] = d;
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) {
    const int t = base + i;
    sc[i] = warp_sum(sc[i]);
    if (t <= pos) {
      sc[i] = sc[i] * scale + (mask[t] != 0 ? 0.f : kNegInf);
      m = fmaxf(m, sc[i]);
    }
  }
  float s = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) {
    const int t = base + i;
    if (t <= pos) {
      const float p = expf(sc[i] - m);
      const float2 vv = t < pos ? load2(vc + (long long)t * D + col)
                                : make_float2(round_to<A>(v_new[col]),
                                              round_to<A>(v_new[col + 1]));
      s += p;
      a0 = fmaf(p, vv.x, a0);
      a1 = fmaf(p, vv.y, a1);
    }
  }
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  wacc[warp][2 * lane] = a0;
  wacc[warp][2 * lane + 1] = a1;
  __syncthreads();

  if (threadIdx.x < kHeadDim) {
    // warps with no slot in [0, pos] have s == 0 and are skipped
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w)
      if (ws[w] > 0.f) M = fmaxf(M, wm[w]);
    float S = 0.f, Acc = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) {
      if (ws[w] > 0.f) {
        const float f = expf(wm[w] - M);
        S = fmaf(ws[w], f, S);
        Acc = fmaf(wacc[w][threadIdx.x], f, Acc);
      }
    }
    if (threadIdx.x == 0) {
      out[0] = M;
      out[1] = S;
    }
    out[2 + threadIdx.x] = Acc;
  }
}

// The combined context of one head (thread d of kHeadDim) over n_split chunk
// partials laid out contiguously from p.  Chunk 0 holds slot 0, so the sum
// is positive.
__device__ __forceinline__ float attn_combine(const float* __restrict__ p, int n_split, int d) {
  float M = -INFINITY;
  for (int c = 0; c < n_split; ++c) M = fmaxf(M, p[c * (2 + kHeadDim)]);
  float S = 0.f, Acc = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float* pc = p + c * (2 + kHeadDim);
    const float f = expf(pc[0] - M);
    S = fmaf(pc[1], f, S);
    Acc = fmaf(pc[2 + d], f, Acc);
  }
  return Acc / S;
}

template <typename T>
__global__ void to_f32_kernel(const T* __restrict__ in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = to_f32(in[i]);
}

template <typename T>
__global__ void from_f32_kernel(const float* __restrict__ in, T* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store(out + i, in[i]);
}

}  // namespace
