// Device helpers shared by the decode-trunk kernels for Hopper (sm_90a):
// decode_layer.cu (K2, one row) and pool_trunk.cu (K4, S pool rows), whose
// products run on the core in trunk_products.cuh.
//
// Types: the activation type A is bf16 or fp32; the cache type C is A or fp8
// e4m3.  fp8 conversion rounds to nearest even, as torch's float8_e4m3fn cast
// and the JAX package's; a magnitude of 480 or more (and NaN) becomes NaN, no
// saturation (CUDA's __NV_SATFINITE would clamp at 448).
//
// Chained launches: every kernel of a trunk step is launched with
// programmatic stream serialization (launch_pdl).  A kernel may run its
// prologue while the previous one drains, but it touches nothing that an
// earlier kernel writes before pdl_wait(); after it, every earlier kernel of
// the stream has finished and its writes are visible.
//
// Attention over one row's cache (attn_kernel): one block per (head, chunk
// of slots, row).  A group of lanes owns a slot and reads its 64-value head
// row 16 bytes a lane (8 lanes for bf16, 4 for e4m3, 16 for fp32), with q
// in registers; the group's dot needs log2(group) shuffles.  Each group
// keeps an online softmax, the block joins its groups, and the last block
// of a (row, head) to finish (a ticket) joins the chunks in chunk order and
// writes the context.  The token's own slot pos is read from the fp32 qkv
// rounded to A (the TPU kernels merge the new row into their chunk in the
// compute type); slots before pos come from the cache.  The mask is
// additive (-1e9 where it is 0): a row whose mask is all zero averages its
// slots and stays finite.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kAttnThreads = 128;
constexpr int kStatCols = 32;  // LayerNorm statistics are kept per 32-column tile
constexpr float kNegInf = -1e9f;

enum WeightForm { kPlain = 0, kInt8 = 1, kInt4 = 2 };

struct fp8_e4m3 {
  uint8_t bits;
};

__device__ __forceinline__ float e4m3_to_f32(uint32_t v) {
  const uint32_t sign = (v & 0x80) << 24;
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

// The 16 / sizeof(C) values of one 16-byte word of a cache row, as floats.
__device__ __forceinline__ void unpack16(const uint4& w, float* out, float) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(const uint4& w, float* out, __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
// e4m3 through the hardware's conversion to f16 (exact: every e4m3 value,
// subnormals included, is an f16; the two NaN codes stay NaN), two codes an
// instruction; chip_smoke.py holds it against torch's cast on all 256 codes.
__device__ __forceinline__ void unpack16(const uint4& w, float* out, fp8_e4m3) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(u[i] >> (16 * j)), __NV_E4M3);
      out[4 * i + 2 * j] = __half2float(__ushort_as_half(h.x));
      out[4 * i + 2 * j + 1] = __half2float(__ushort_as_half(h.y));
    }
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

// ---- chained launches -------------------------------------------------------

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launch `kernel` on `st` with programmatic stream serialization; returns
// the launch's error code (0 when it was accepted).
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem, cudaStream_t st,
               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// The last block of a group of `count` blocks to reach this call returns
// true (every thread of it).  The block's earlier global writes are ordered
// before thread 0's release-acquire add (the barrier, then a cumulative
// release); the last block's acquire and second barrier make every block's
// writes visible to all its threads (read them through L2, __ldcg).  The
// last block resets the counter to 0 for the next use.
__device__ __forceinline__ bool take_ticket(int* counter, int count) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
    last = old == count - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  return last;
}

// ---- LayerNorm statistics ---------------------------------------------------
// Whoever writes the residual x also writes, for each row and 32-column
// tile, {mean, M2} of the tile (M2 = sum of squared deviations from the
// tile's mean).  A consumer joins the tiles in a fixed order (Chan's rule,
// trunk_products.cuh): the same grade of result as a mean then a centred
// variance.

// {mean, M2} of one row's 32 values, one per lane, on every lane.
__device__ __forceinline__ float2 tile_stats(float v) {
  const float mean = warp_sum(v) * (1.f / kStatCols);
  const float d = v - mean;
  return make_float2(mean, warp_sum(d * d));
}

// ---- the step's first and last kernels --------------------------------------

// x[s] = fp32(hidden[s]) and its tile statistics, one warp per 32-column
// tile; also zeroes the step's n_zero ticket counters.  Grid (D / 32, S).
template <typename A>
__global__ void __launch_bounds__(32)
trunk_in_kernel(const A* __restrict__ hidden, float* __restrict__ x,
                float2* __restrict__ stats, int* __restrict__ counters, int n_zero, int D) {
  pdl_wait();
  pdl_launch_dependents();
  const int s = blockIdx.y, t = blockIdx.x, n_tiles = gridDim.x;
  const long long i = (long long)s * D + t * kStatCols + threadIdx.x;
  const float v = to_f32(hidden[i]);
  x[i] = v;
  const float2 st = tile_stats(v);
  if (threadIdx.x == 0) stats[(long long)s * n_tiles + t] = st;
  const int b = s * n_tiles + t, nb = n_tiles * gridDim.y;
  for (int c = b * 32 + threadIdx.x; c < n_zero; c += nb * 32) counters[c] = 0;
}

template <typename A>
__global__ void __launch_bounds__(256)
trunk_out_kernel(const float* __restrict__ x, A* __restrict__ out, int n) {
  pdl_wait();
  pdl_launch_dependents();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store(out + i, x[i]);
}

// ---- attention --------------------------------------------------------------

struct AttnArgs {
  const float* qkv;       // [S, 3D] this step's fp32 q | k | v
  const void* kc;         // this layer's cache: row s at kc + s * T * D, [T, D]
  const void* vc;
  const int* mask;        // [S, T]
  const int* positions;   // [S] on the device, or null: every row at `pos`
  int pos, D, T, chunk;   // chunk: slots per block
  float scale;
  float* part;            // [S, H, n_chunks, 2 + hd] chunk partials
  int* counters;          // [S, H] tickets
  float* ctx;             // [S, D]
};

__device__ __forceinline__ int row_position(const AttnArgs& a, int s) {
  return a.positions != nullptr ? min(max(a.positions[s], 0), a.T - 1) : a.pos;
}

// Grid (H, n_chunks, S), kAttnThreads threads.
template <typename A, typename C>
__global__ void __launch_bounds__(kAttnThreads)
attn_kernel(const AttnArgs a) {
  constexpr int kVals = 16 / sizeof(C);              // values per lane per word
  constexpr int kLanes = kHeadDim / kVals;           // lanes per slot
  constexpr int kGroups = kAttnThreads / kLanes;     // slots in flight per block
  __shared__ float gm[kGroups], gs[kGroups], gacc[kGroups][kHeadDim + 1];
  pdl_wait();
  pdl_launch_dependents();
  const int h = blockIdx.x, chunk = blockIdx.y, s = blockIdx.z;
  const int H = gridDim.x, n_chunks = gridDim.y;
  const int pos = row_position(a, s);
  if (chunk * a.chunk > pos) return;  // no slot of [0, pos] here (no ticket either)
  const int D = a.D;
  const int group = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int col = h * kHeadDim + sub * kVals;
  const float* qrow = a.qkv + (long long)s * 3 * D;
  float q[kVals], acc[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    q[i] = qrow[col + i];
    acc[i] = 0.f;
  }
  const C* kc = static_cast<const C*>(a.kc) + (long long)s * a.T * D;
  const C* vc = static_cast<const C*>(a.vc) + (long long)s * a.T * D;
  const int* mask = a.mask + (long long)s * a.T;
  const int t0 = chunk * a.chunk, t1 = min(pos, t0 + a.chunk - 1);
  float m = -INFINITY, sum = 0.f;
  // the next slot's words and mask are in flight while this one is used
  auto fetch = [&](int t, uint4& kw, uint4& vw, int& mk) {
    if (t < pos) {
      kw = __ldg(reinterpret_cast<const uint4*>(kc + (long long)t * D + col));
      vw = __ldg(reinterpret_cast<const uint4*>(vc + (long long)t * D + col));
    }
    if (t <= t1) mk = mask[t];
  };
  uint4 kw = make_uint4(0, 0, 0, 0), vw = kw;
  int mk = 0;
  fetch(t0 + group, kw, vw, mk);
  for (int base = t0; base <= t1; base += kGroups) {  // uniform over the block
    const int t = base + group;
    uint4 kn = make_uint4(0, 0, 0, 0), vn = kn;
    int mn = 0;
    if (base + kGroups <= t1) fetch(t + kGroups, kn, vn, mn);
    float kv[kVals], vv[kVals];
    if (t < pos) {
      unpack16(kw, kv, C{});
      unpack16(vw, vv, C{});
    } else {  // slot pos (past t1 the values are not used)
#pragma unroll
      for (int i = 0; i < kVals; ++i) {
        kv[i] = round_to<A>(qrow[D + col + i]);
        vv[i] = round_to<A>(qrow[2 * D + col + i]);
      }
    }
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < kVals; ++i) d = fmaf(q[i], kv[i], d);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (t <= t1) {
      const float sc = d * a.scale + (mk != 0 ? 0.f : kNegInf);
      const float m_new = fmaxf(m, sc);
      const float alpha = expf(m - m_new), p = expf(sc - m_new);
      sum = fmaf(sum, alpha, p);
#pragma unroll
      for (int i = 0; i < kVals; ++i) acc[i] = fmaf(acc[i], alpha, p * vv[i]);
      m = m_new;
    }
    kw = kn;
    vw = vn;
    mk = mn;
  }
  if (sub == 0) {
    gm[group] = m;
    gs[group] = sum;
  }
#pragma unroll
  for (int i = 0; i < kVals; ++i) gacc[group][sub * kVals + i] = acc[i];
  __syncthreads();

  // the chunk's softmax: groups with no slot (sum 0) are skipped
  float* out = a.part + (((long long)s * H + h) * n_chunks + chunk) * (2 + kHeadDim);
  if (threadIdx.x < kHeadDim) {
    float M = -INFINITY;
    for (int g = 0; g < kGroups; ++g)
      if (gs[g] > 0.f) M = fmaxf(M, gm[g]);
    float S = 0.f, Acc = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      if (gs[g] > 0.f) {
        const float f = expf(gm[g] - M);
        S = fmaf(gs[g], f, S);
        Acc = fmaf(gacc[g][threadIdx.x], f, Acc);
      }
    }
    if (threadIdx.x == 0) {
      out[0] = M;
      out[1] = S;
    }
    out[2 + threadIdx.x] = Acc;
  }
  const int live = pos / a.chunk + 1;
  if (!take_ticket(a.counters + (long long)s * H + h, live)) return;

  // the last chunk block of (s, h): join the chunks in order (chunk 0 holds
  // slot 0, so the sum is positive)
  const float* p0 = a.part + ((long long)s * H + h) * n_chunks * (2 + kHeadDim);
  if (threadIdx.x < kHeadDim) {
    float M = -INFINITY;
#pragma unroll 4
    for (int c = 0; c < live; ++c) M = fmaxf(M, __ldcg(p0 + c * (2 + kHeadDim)));
    float S = 0.f, Acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < live; ++c) {
      const float* pc = p0 + c * (2 + kHeadDim);
      const float f = expf(__ldcg(pc) - M);
      S = fmaf(__ldcg(pc + 1), f, S);
      Acc = fmaf(__ldcg(pc + 2 + threadIdx.x), f, Acc);
    }
    a.ctx[(long long)s * D + h * kHeadDim + threadIdx.x] = Acc / S;
  }
}

// The attention path's fp8 decoding (unpack16) over 16-byte words, for
// holding it against torch's cast on all 256 codes.
__global__ void e4m3_unpack_kernel(const uint4* __restrict__ in, float* __restrict__ out,
                                   int n_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_words) unpack16(in[i], out + 16 * i, fp8_e4m3{});
}

}  // namespace
