// One single-row GPT-2 decode step through all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/decode_layer.py
// (fused_decode_trunk_flat, :272; body _kernel, :63) on all its tiers.  For
// each layer l, with the residual stream x kept in fp32:
//
//   qkv  = LN1(x) @ qkv_w[l] + qkv_b[l]      new K/V rows -> cache[l, pos]
//   ctx  = softmax(q k^T / sqrt(hd) + mask) v   over cache slots [0, pos]
//   x   += ctx @ proj_w[l] + proj_b[l]
//   x   += gelu_new(LN2(x) @ fc_w[l] + fc_b[l]) @ mproj_w[l] + mproj_b[l]
//
// and writes x (before ln_f) in the activation type A (bf16 or fp32), the
// type of hidden, the LayerNorm parameters and the biases.  Weights are
// stacked [L, K, N] and K-major, in one of three forms (template kForm):
//   kPlain  A                                  x @ w
//   kInt8   q int8 [L, K, N], s fp32 [L, 1, N]  (x @ q) * s
//   kInt4   q4 int8 [L, K/2, N], s fp32 [L, 2G, N]: K splits into G chunks;
//           in chunk g, byte row j holds row 2g*h + j in its low nibble and
//           row 2g*h + h + j in its high nibble (h = K / 2G), and the two
//           halves scale by rows 2g and 2g + 1 (ops/quantization.py's fused
//           layout; G = 4 for the MLP down-projection, 1 elsewhere).
// The cache (template C) is flat [L, T, D] head-major, in A or fp8 e4m3:
// the qkv kernel writes the new rows converted to C, attention upcasts on
// load, and the token's own slot is read from the fp32 qkv rounded to A, as
// the TPU kernel merges its row into the chunk in the compute type.
// LayerNorm (eps 1e-5), softmax and every accumulation are fp32; the mask is
// additive (-1e9 where attention_mask is 0).
//
// Bound on the H100: a step reads every weight once (12 D^2 values a layer:
// 943.7 MB in bf16 at D=1280, L=24; ~473 MB int8, ~239 MB int4) plus
// 2 (pos+1) D cache values a layer, against about 2 flops per weight:
// device memory bandwidth bounds it.  Design, simple first: six kernels per
// layer.  The GEMV kernels give each block 16 output columns over the full
// K, so sums stay deterministic; every 8 lanes read one 32-byte sector of a
// bf16 weight row (16 bytes of int8, 16 of packed int4).  LayerNorm is
// recomputed by each block from x (5 KB, from L2) into shared memory.  The
// int4 GEMV keeps one fp32 partial sum per (group, half) and column and
// scales it by its row before adding it to the column's sum; int8 scales the
// column's whole sum.  Attention splits [0, pos] into 64-slot chunks, one
// block per (head, chunk), with a softmax per chunk that a second kernel
// combines across chunks.  Launch overhead (6 L + 2 launches a step) is the
// known gap to the bound.
//
// The fp8 conversions and the attention block are shared with pool_trunk.cu
// (trunk_common.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_common.cuh"

namespace {

constexpr int kGemvThreads = 256;
constexpr int kGemvCols = 16;  // 8 lanes x 2 columns
constexpr int kGemvRows = kGemvThreads / (kGemvCols / 2);  // 32 rows per pass

// the two int8 values at p (p even-aligned)
__device__ __forceinline__ char2 load_i8x2(const int8_t* p) {
  return *reinterpret_cast<const char2*>(p);
}
// sign-extended nibbles of a packed byte: two shifts each
__device__ __forceinline__ float nib_lo(signed char b) {
  return static_cast<float>(static_cast<int32_t>(static_cast<uint32_t>(b) << 28) >> 28);
}
__device__ __forceinline__ float nib_hi(signed char b) {
  return static_cast<float>(static_cast<int32_t>(static_cast<uint32_t>(b) << 24) >> 28);
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

// out[n] (op) vin @ W[:, n] + bias[n] for this block's 16 columns, with vin
// = LN(in) when ln_s is given, else in.  W: [K, N] K-major in form kForm
// (w, and for the quantized forms its scales ws with G contraction groups).
// kStore also writes columns [D, 2D) and [2D, 3D) into k_row / v_row (the
// new cache rows) in the cache type C.
template <typename A, typename C, int kForm>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const float* __restrict__ in, const A* __restrict__ ln_s,
            const A* __restrict__ ln_b, const void* __restrict__ w,
            const float* __restrict__ ws, int G, const A* __restrict__ bias,
            float* __restrict__ out, int K, int N, int epi, C* __restrict__ k_row,
            C* __restrict__ v_row, int D) {
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
    if constexpr (kForm == kPlain) {
      const A* wp = static_cast<const A*>(w) + n0;
#pragma unroll 8
      for (int k = r; k < K; k += kGemvRows) {
        const float2 wv = load2(wp + (long long)k * N);
        const float xv = vin[k];
        acc0 = fmaf(xv, wv.x, acc0);
        acc1 = fmaf(xv, wv.y, acc1);
      }
    } else if constexpr (kForm == kInt8) {
      const int8_t* wp = static_cast<const int8_t*>(w) + n0;
#pragma unroll 8
      for (int k = r; k < K; k += kGemvRows) {
        const char2 b = load_i8x2(wp + (long long)k * N);
        const float xv = vin[k];
        acc0 = fmaf(xv, static_cast<float>(b.x), acc0);
        acc1 = fmaf(xv, static_cast<float>(b.y), acc1);
      }
    } else {
      const int8_t* wp = static_cast<const int8_t*>(w) + n0;
      const int half = K / (2 * G);
      for (int g = 0; g < G; ++g) {
        const float* xl = vin + 2 * g * half;  // rows of the low nibbles
        const float* xh = xl + half;           // rows of the high nibbles
        float lo0 = 0.f, lo1 = 0.f, hi0 = 0.f, hi1 = 0.f;
#pragma unroll 4
        for (int j = r; j < half; j += kGemvRows) {
          const char2 b = load_i8x2(wp + (long long)(g * half + j) * N);
          lo0 = fmaf(xl[j], nib_lo(b.x), lo0);
          lo1 = fmaf(xl[j], nib_lo(b.y), lo1);
          hi0 = fmaf(xh[j], nib_hi(b.x), hi0);
          hi1 = fmaf(xh[j], nib_hi(b.y), hi1);
        }
        const float* s_lo = ws + (long long)(2 * g) * N + n0;
        const float* s_hi = s_lo + N;
        acc0 += lo0 * s_lo[0] + hi0 * s_hi[0];
        acc1 += lo1 * s_lo[1] + hi1 * s_hi[1];
      }
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
      if constexpr (kForm == kInt8) sum *= ws[n];
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
// qkv: this step's fp32 q | k | v; slot pos is read from there, rounded to A.
// Writes part[(h * n_split + chunk) * (2 + hd)] = {max, sum, acc[hd]}.
template <typename A, typename C>
__global__ void __launch_bounds__(kAttnWarps * 32)
attn_partial_kernel(const float* __restrict__ qkv, const C* __restrict__ kc,
                    const C* __restrict__ vc, const int* __restrict__ mask, int pos, int D,
                    float scale, float* __restrict__ part) {
  const int h = blockIdx.x, chunk = blockIdx.y;
  attn_partial_block<A, C>(qkv, qkv + D, qkv + 2 * D, kc, vc, mask, pos, D, scale, h, chunk,
                           part + ((long long)h * gridDim.y + chunk) * (2 + kHeadDim));
}

// ctx[h * hd + d] = combined softmax-weighted sum over the chunks of head h.
__global__ void attn_combine_kernel(const float* __restrict__ part, int n_split,
                                    float* __restrict__ ctx) {
  const int h = blockIdx.x, d = threadIdx.x;
  ctx[h * kHeadDim + d] = attn_combine(part + (long long)h * n_split * (2 + kHeadDim), n_split, d);
}

// One stacked matrix: its data, the fp32 scales of a quantized form, and
// the number of contraction groups of an int4 one.
struct Matrix {
  const void* w;
  const float* s;
  int groups;
};

struct Params {
  const void *ln1_s, *ln1_b;
  Matrix qkv;
  const void* qkv_b;
  Matrix proj;
  const void *proj_b, *ln2_s, *ln2_b;
  Matrix fc;
  const void* fc_b;
  Matrix mproj;
  const void* mproj_b;
};

// Layer l of a stacked [L, K, N] matrix in form kForm.
template <typename A, int kForm>
Matrix layer_of(const Matrix& m, int l, long long K, long long N) {
  if constexpr (kForm == kPlain)
    return {static_cast<const A*>(m.w) + l * K * N, nullptr, 1};
  else if constexpr (kForm == kInt8)
    return {static_cast<const int8_t*>(m.w) + l * K * N, m.s + l * N, 1};
  else
    return {static_cast<const int8_t*>(m.w) + l * (K / 2) * N,
            m.s + (long long)l * 2 * m.groups * N, m.groups};
}

template <typename A, typename C, int kForm>
int gemv(cudaStream_t s, const float* in, const A* ln_s, const A* ln_b, const Matrix& m,
         const A* b, float* out, int K, int N, int epi, C* k_row, C* v_row, int D) {
  const int blocks = (N + kGemvCols - 1) / kGemvCols;
  gemv_kernel<A, C, kForm><<<blocks, kGemvThreads, K * sizeof(float), s>>>(
      in, ln_s, ln_b, m.w, m.s, m.groups, b, out, K, N, epi, k_row, v_row, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename C, int kForm>
int trunk_step(const Params& P, const A* hidden, A* out, C* kc, C* vc, const int* mask,
               int pos, int L, int D, int H, int T_len, float* scratch, cudaStream_t s) {
  float* x = scratch;
  float* qkv = x + D;
  float* ctx = qkv + 3 * D;
  float* hbuf = ctx + D;
  float* part = hbuf + 4 * D;
  const int n_split = pos / kAttnChunk + 1;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / H));
  int rc;

  to_f32_kernel<A><<<(D + 255) / 256, 256, 0, s>>>(hidden, x, D);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  for (int l = 0; l < L; ++l) {
    const A* ln1_s = static_cast<const A*>(P.ln1_s) + (long long)l * D;
    const A* ln1_b = static_cast<const A*>(P.ln1_b) + (long long)l * D;
    const A* qkv_b = static_cast<const A*>(P.qkv_b) + (long long)l * 3 * D;
    const A* proj_b = static_cast<const A*>(P.proj_b) + (long long)l * D;
    const A* ln2_s = static_cast<const A*>(P.ln2_s) + (long long)l * D;
    const A* ln2_b = static_cast<const A*>(P.ln2_b) + (long long)l * D;
    const A* fc_b = static_cast<const A*>(P.fc_b) + (long long)l * 4 * D;
    const A* mproj_b = static_cast<const A*>(P.mproj_b) + (long long)l * D;
    const Matrix qkv_w = layer_of<A, kForm>(P.qkv, l, D, 3 * D);
    const Matrix proj_w = layer_of<A, kForm>(P.proj, l, D, D);
    const Matrix fc_w = layer_of<A, kForm>(P.fc, l, D, 4 * D);
    const Matrix mproj_w = layer_of<A, kForm>(P.mproj, l, 4 * D, D);
    C* kl = kc + (long long)l * T_len * D;
    C* vl = vc + (long long)l * T_len * D;

    if ((rc = gemv<A, C, kForm>(s, x, ln1_s, ln1_b, qkv_w, qkv_b, qkv, D, 3 * D, kStore,
                                kl + (long long)pos * D, vl + (long long)pos * D, D)))
      return rc;
    attn_partial_kernel<A, C><<<dim3(H, n_split), kAttnWarps * 32, 0, s>>>(
        qkv, kl, vl, mask, pos, D, scale, part);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    attn_combine_kernel<<<H, kHeadDim, 0, s>>>(part, n_split, ctx);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    if ((rc = gemv<A, C, kForm>(s, ctx, nullptr, nullptr, proj_w, proj_b, x, D, D, kAddTo,
                                nullptr, nullptr, D)))
      return rc;
    if ((rc = gemv<A, C, kForm>(s, x, ln2_s, ln2_b, fc_w, fc_b, hbuf, D, 4 * D, kStoreGelu,
                                nullptr, nullptr, D)))
      return rc;
    if ((rc = gemv<A, C, kForm>(s, hbuf, nullptr, nullptr, mproj_w, mproj_b, x, 4 * D, D,
                                kAddTo, nullptr, nullptr, D)))
      return rc;
  }
  from_f32_kernel<A><<<(D + 255) / 256, 256, 0, s>>>(x, out, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename C>
int dispatch_form(int form, const Params& P, const void* hidden, void* out, void* k, void* v,
                  const int* mask, int pos, int L, int D, int H, int T, float* scratch,
                  cudaStream_t s) {
  const A* h = static_cast<const A*>(hidden);
  A* o = static_cast<A*>(out);
  C* kc = static_cast<C*>(k);
  C* vc = static_cast<C*>(v);
  switch (form) {
    case kPlain:
      return trunk_step<A, C, kPlain>(P, h, o, kc, vc, mask, pos, L, D, H, T, scratch, s);
    case kInt8:
      return trunk_step<A, C, kInt8>(P, h, o, kc, vc, mask, pos, L, D, H, T, scratch, s);
    case kInt4:
      return trunk_step<A, C, kInt4>(P, h, o, kc, vc, mask, pos, L, D, H, T, scratch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void e4m3_roundtrip_kernel(const float* __restrict__ in, uint8_t* __restrict__ bits,
                                      float* __restrict__ back, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    bits[i] = f32_to_e4m3(in[i]);
    back[i] = e4m3_to_f32(bits[i]);
  }
}

}  // namespace

// Floats of fp32 scratch that decode_trunk_step needs.
extern "C" long long decode_trunk_scratch_floats(int D, int H, int T) {
  return 9LL * D + (long long)H * ((T + kAttnChunk - 1) / kAttnChunk) * (2 + kHeadDim);
}

// One decode step over all L layers.  act_bf16: hidden, out, LayerNorm
// parameters and biases are bf16 (else fp32); form: 0 plain (weights in the
// activation type), 1 int8, 2 fused int4 (each matrix: data, fp32 scales,
// contraction groups); cache_fp8: the cache is e4m3 (else the activation
// type).  hidden, out: [D]; k, v: [L, T, D] (the new rows are written at slot
// pos, in place); mask: [T] int32.  Requires D / H == 64, D % 16 == 0,
// 0 <= pos < T, and for int4 K % (2 * groups) == 0.  Returns
// cudaGetLastError().
extern "C" int decode_trunk_step(
    int act_bf16, int form, int cache_fp8, const void* hidden, void* out, void* k, void* v,
    const int* mask, int pos, int L, int D, int H, int T, const void* ln1_s,
    const void* ln1_b, const void* qkv_w, const float* qkv_s, int qkv_g, const void* qkv_b,
    const void* proj_w, const float* proj_s, int proj_g, const void* proj_b,
    const void* ln2_s, const void* ln2_b, const void* fc_w, const float* fc_s, int fc_g,
    const void* fc_b, const void* mproj_w, const float* mproj_s, int mproj_g,
    const void* mproj_b, float* scratch, void* stream) {
  if (D / H != kHeadDim || D % kGemvCols != 0 || pos < 0 || pos >= T)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == kInt4 && (qkv_g < 1 || proj_g < 1 || fc_g < 1 || mproj_g < 1 ||
                        D % (2 * qkv_g) || D % (2 * proj_g) || D % (2 * fc_g) ||
                        (4 * D) % (2 * mproj_g)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{ln1_s, ln1_b, {qkv_w, qkv_s, qkv_g},       qkv_b, {proj_w, proj_s, proj_g},
                 proj_b, ln2_s, ln2_b, {fc_w, fc_s, fc_g}, fc_b,  {mproj_w, mproj_s, mproj_g},
                 mproj_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    if (cache_fp8)
      return dispatch_form<__nv_bfloat16, fp8_e4m3>(form, P, hidden, out, k, v, mask, pos, L,
                                                    D, H, T, scratch, s);
    return dispatch_form<__nv_bfloat16, __nv_bfloat16>(form, P, hidden, out, k, v, mask, pos,
                                                       L, D, H, T, scratch, s);
  }
  if (cache_fp8)
    return dispatch_form<float, fp8_e4m3>(form, P, hidden, out, k, v, mask, pos, L, D, H, T,
                                          scratch, s);
  return dispatch_form<float, float>(form, P, hidden, out, k, v, mask, pos, L, D, H, T,
                                     scratch, s);
}

// The kernel's fp8 conversions on n floats: bits[i] = e4m3(in[i]) and
// back[i] = float(bits[i]), for holding them against torch's cast.
extern "C" int fp8_e4m3_roundtrip(const float* in, uint8_t* bits, float* back, int n,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  e4m3_roundtrip_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      in, bits, back, n);
  return static_cast<int>(cudaGetLastError());
}
