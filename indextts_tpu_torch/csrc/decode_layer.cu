// One single-row GPT-2 decode step through all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/decode_layer.py
// (fused_decode_trunk_flat, :272; body _kernel, :63) on its plain-weight
// tier.  For each layer l, with the residual stream x kept in fp32:
//
//   qkv  = LN1(x) @ qkv_w[l] + qkv_b[l]      new K/V rows -> cache[l, pos]
//   ctx  = softmax(q k^T / sqrt(hd) + mask) v   over cache slots [0, pos]
//   x   += ctx @ proj_w[l] + proj_b[l]
//   x   += gelu_new(LN2(x) @ fc_w[l] + fc_b[l]) @ mproj_w[l] + mproj_b[l]
//
// and writes x (before ln_f) in the input type.  Weights are stacked
// [L, K, N] and K-major, the cache is flat [L, T, D] head-major; weights,
// cache and hidden share one type (bf16 or fp32).  LayerNorm (eps 1e-5),
// softmax and every accumulation are fp32; the mask is additive (-1e9 where
// attention_mask is 0).
//
// Bound on the H100: a step reads every weight once, 12 D^2 values per layer
// (943.7 MB in bf16 at D=1280, L=24) plus 2 (pos+1) D cache values per layer,
// against about 2 flops per weight: device memory bandwidth bounds it.
// Design, simple first: six kernels per layer.  The GEMV kernels give each
// block 16 output columns over the full K, so sums stay deterministic and
// every 8 lanes read one 32-byte sector of a weight row; LayerNorm is
// recomputed by each block from x (5 KB, from L2) into shared memory.
// Attention splits [0, pos] into 64-slot chunks, one block per (head, chunk),
// with a softmax per chunk that a second kernel combines across chunks.
// Launch overhead (6 L + 2 launches a step) is the known gap to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGemvThreads = 256;
constexpr int kGemvCols = 16;  // 8 lanes x 2 columns
constexpr int kGemvRows = kGemvThreads / (kGemvCols / 2);  // 32 rows per pass
constexpr int kHeadDim = 64;
constexpr int kAttnChunk = 64;  // cache slots per attention block
constexpr int kAttnWarps = 4;
constexpr int kSlotsPerWarp = kAttnChunk / kAttnWarps;
constexpr float kNegInf = -1e9f;

enum Epilogue { kStore = 0, kStoreGelu = 1, kAddTo = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block (blockDim.x == kGemvThreads); every thread gets it.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kGemvThreads / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float gelu_new(float h) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
}

// out[n] (op) vin @ w[:, n] + bias[n] for this block's 16 columns, with vin
// = LN(in) when ln_s is given, else in.  w: [K, N] K-major.  kStore also
// copies columns [D, 2D) and [2D, 3D) into k_row / v_row (the new cache
// rows) in the weight type.
template <typename W>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const float* __restrict__ in, const W* __restrict__ ln_s,
            const W* __restrict__ ln_b, const W* __restrict__ w,
            const W* __restrict__ bias, float* __restrict__ out, int K, int N, int epi,
            W* __restrict__ k_row, W* __restrict__ v_row, int D) {
  extern __shared__ float vin[];  // [K]
  __shared__ float red[kGemvRows][kGemvCols];
  __shared__ float stat[kGemvThreads / 32];

  for (int k = threadIdx.x; k < K; k += kGemvThreads) vin[k] = in[k];
  if (ln_s != nullptr) {
    float s = 0.f;
    for (int k = threadIdx.x; k < K; k += kGemvThreads) s += vin[k];
    const float mean = block_sum(s, stat) / K;
    float q = 0.f;
    for (int k = threadIdx.x; k < K; k += kGemvThreads) {
      const float d = vin[k] - mean;
      q += d * d;
    }
    const float var = block_sum(q, stat) / K;
    const float rstd = rsqrtf(var + 1e-5f);
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += kGemvThreads)
      vin[k] = (vin[k] - mean) * rstd * to_f32(ln_s[k]) + to_f32(ln_b[k]);
  }
  __syncthreads();

  const int pair = threadIdx.x & (kGemvCols / 2 - 1);
  const int r = threadIdx.x / (kGemvCols / 2);
  const int n0 = blockIdx.x * kGemvCols + 2 * pair;
  float acc0 = 0.f, acc1 = 0.f;
  if (n0 < N) {
    const W* wp = w + n0;
#pragma unroll 8
    for (int k = r; k < K; k += kGemvRows) {
      const float2 wv = load2(wp + (long long)k * N);
      const float xv = vin[k];
      acc0 = fmaf(xv, wv.x, acc0);
      acc1 = fmaf(xv, wv.y, acc1);
    }
  }
  red[r][2 * pair] = acc0;
  red[r][2 * pair + 1] = acc1;
  __syncthreads();

  if (threadIdx.x < kGemvCols) {
    const int n = blockIdx.x * kGemvCols + threadIdx.x;
    if (n < N) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kGemvRows; ++i) sum += red[i][threadIdx.x];
      const float b = to_f32(bias[n]);
      if (epi == kAddTo) {
        out[n] = (out[n] + sum) + b;
      } else {
        const float v = sum + b;
        out[n] = (epi == kStoreGelu) ? gelu_new(v) : v;
        if (k_row != nullptr && n >= D && n < 2 * D) store(k_row + (n - D), v);
        if (v_row != nullptr && n >= 2 * D) store(v_row + (n - 2 * D), v);
      }
    }
  }
}

// One block per (head, 64-slot chunk of [0, pos]); 4 warps of 16 slots.
// Writes part[(h * n_split + chunk) * (2 + hd)] = {max, sum, acc[hd]}.
template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
attn_partial_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ mask, int pos, int D,
                    float scale, float* __restrict__ part) {
  __shared__ float wm[kAttnWarps], ws[kAttnWarps], wacc[kAttnWarps][kHeadDim];
  const int h = blockIdx.x, chunk = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = h * kHeadDim + 2 * lane;
  const float q0 = q[col], q1 = q[col + 1];
  const int base = chunk * kAttnChunk + warp * kSlotsPerWarp;

  float sc[kSlotsPerWarp];
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) {
    const int t = base + i;
    float d = 0.f;
    if (t <= pos) {
      const float2 kv = load2(kc + (long long)t * D + col);
      d = q0 * kv.x + q1 * kv.y;
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
      const float2 vv = load2(vc + (long long)t * D + col);
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
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w)
      if (ws[w] > 0.f) M = fmaxf(M, wm[w]);
    float S = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) {
      if (ws[w] > 0.f) {
        const float f = expf(wm[w] - M);
        S = fmaf(ws[w], f, S);
        A = fmaf(wacc[w][threadIdx.x], f, A);
      }
    }
    float* out = part + ((long long)h * n_split + chunk) * (2 + kHeadDim);
    if (threadIdx.x == 0) {
      out[0] = M;
      out[1] = S;
    }
    out[2 + threadIdx.x] = A;
  }
}

// ctx[h * hd + d] = combined softmax-weighted sum over the chunks of head h.
__global__ void attn_combine_kernel(const float* __restrict__ part, int n_split,
                                    float* __restrict__ ctx) {
  const int h = blockIdx.x, d = threadIdx.x;
  const float* p = part + (long long)h * n_split * (2 + kHeadDim);
  float M = -INFINITY;
  for (int c = 0; c < n_split; ++c) M = fmaxf(M, p[c * (2 + kHeadDim)]);
  float S = 0.f, A = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float* pc = p + c * (2 + kHeadDim);
    const float f = expf(pc[0] - M);
    S = fmaf(pc[1], f, S);
    A = fmaf(pc[2 + d], f, A);
  }
  ctx[h * kHeadDim + d] = A / S;
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

struct Params {
  const void *ln1_s, *ln1_b, *qkv_w, *qkv_b, *proj_w, *proj_b;
  const void *ln2_s, *ln2_b, *fc_w, *fc_b, *mproj_w, *mproj_b;
};

template <typename T>
int gemv(cudaStream_t s, const float* in, const T* ln_s, const T* ln_b, const T* w,
         const T* b, float* out, int K, int N, int epi, T* k_row, T* v_row, int D) {
  const int blocks = (N + kGemvCols - 1) / kGemvCols;
  gemv_kernel<T><<<blocks, kGemvThreads, K * sizeof(float), s>>>(
      in, ln_s, ln_b, w, b, out, K, N, epi, k_row, v_row, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int trunk_step(const Params& P, const T* hidden, T* out, T* kc, T* vc, const int* mask,
               int pos, int L, int D, int H, int T_len, float* scratch, cudaStream_t s) {
  float* x = scratch;
  float* qkv = x + D;
  float* ctx = qkv + 3 * D;
  float* hbuf = ctx + D;
  float* part = hbuf + 4 * D;
  const int n_split = pos / kAttnChunk + 1;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / H));
  int rc;

  to_f32_kernel<T><<<(D + 255) / 256, 256, 0, s>>>(hidden, x, D);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  for (int l = 0; l < L; ++l) {
    const long long dd = (long long)D * D;
    const T* ln1_s = static_cast<const T*>(P.ln1_s) + (long long)l * D;
    const T* ln1_b = static_cast<const T*>(P.ln1_b) + (long long)l * D;
    const T* qkv_w = static_cast<const T*>(P.qkv_w) + l * 3 * dd;
    const T* qkv_b = static_cast<const T*>(P.qkv_b) + (long long)l * 3 * D;
    const T* proj_w = static_cast<const T*>(P.proj_w) + l * dd;
    const T* proj_b = static_cast<const T*>(P.proj_b) + (long long)l * D;
    const T* ln2_s = static_cast<const T*>(P.ln2_s) + (long long)l * D;
    const T* ln2_b = static_cast<const T*>(P.ln2_b) + (long long)l * D;
    const T* fc_w = static_cast<const T*>(P.fc_w) + l * 4 * dd;
    const T* fc_b = static_cast<const T*>(P.fc_b) + (long long)l * 4 * D;
    const T* mproj_w = static_cast<const T*>(P.mproj_w) + l * 4 * dd;
    const T* mproj_b = static_cast<const T*>(P.mproj_b) + (long long)l * D;
    T* kl = kc + (long long)l * T_len * D;
    T* vl = vc + (long long)l * T_len * D;

    if ((rc = gemv<T>(s, x, ln1_s, ln1_b, qkv_w, qkv_b, qkv, D, 3 * D, kStore,
                      kl + (long long)pos * D, vl + (long long)pos * D, D)))
      return rc;
    attn_partial_kernel<T><<<dim3(H, n_split), kAttnWarps * 32, 0, s>>>(
        qkv, kl, vl, mask, pos, D, scale, part);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    attn_combine_kernel<<<H, kHeadDim, 0, s>>>(part, n_split, ctx);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    if ((rc = gemv<T>(s, ctx, nullptr, nullptr, proj_w, proj_b, x, D, D, kAddTo,
                      nullptr, nullptr, D)))
      return rc;
    if ((rc = gemv<T>(s, x, ln2_s, ln2_b, fc_w, fc_b, hbuf, D, 4 * D, kStoreGelu,
                      nullptr, nullptr, D)))
      return rc;
    if ((rc = gemv<T>(s, hbuf, nullptr, nullptr, mproj_w, mproj_b, x, 4 * D, D, kAddTo,
                      nullptr, nullptr, D)))
      return rc;
  }
  from_f32_kernel<T><<<(D + 255) / 256, 256, 0, s>>>(x, out, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of fp32 scratch that decode_trunk_step needs.
extern "C" long long decode_trunk_scratch_floats(int D, int H, int T) {
  return 9LL * D + (long long)H * ((T + kAttnChunk - 1) / kAttnChunk) * (2 + kHeadDim);
}

// One decode step over all L layers.  hidden, out: [D]; k, v: [L, T, D]
// (the new rows are written at slot pos, in place); mask: [T] int32; the 12
// weight pointers are the stacked GPT-2 block parameters.  Requires
// D / H == 64, D % 16 == 0 and 0 <= pos < T.  Returns cudaGetLastError().
extern "C" int decode_trunk_step(
    int is_bf16, const void* hidden, void* out, void* k, void* v, const int* mask, int pos,
    int L, int D, int H, int T, const void* ln1_s, const void* ln1_b, const void* qkv_w,
    const void* qkv_b, const void* proj_w, const void* proj_b, const void* ln2_s,
    const void* ln2_b, const void* fc_w, const void* fc_b, const void* mproj_w,
    const void* mproj_b, float* scratch, void* stream) {
  if (D / H != kHeadDim || D % kGemvCols != 0 || pos < 0 || pos >= T)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                 ln2_s, ln2_b, fc_w,  fc_b,  mproj_w, mproj_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return trunk_step<__nv_bfloat16>(
        P, static_cast<const __nv_bfloat16*>(hidden), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(v), mask, pos, L, D, H,
        T, scratch, s);
  return trunk_step<float>(P, static_cast<const float*>(hidden), static_cast<float*>(out),
                           static_cast<float*>(k), static_cast<float*>(v), mask, pos, L, D,
                           H, T, scratch, s);
}
