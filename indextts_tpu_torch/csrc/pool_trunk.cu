// One decode step of S pool rows through all GPT-2 layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/pool_trunk.py
// (fused_pool_step, :296; body _kernel, :82): the continuous-batching pool's
// step, each row at its own cache position.  For each layer l, with the
// residual stream x [S, D] kept in fp32:
//
//   qkv  = LN1(x) @ qkv_w[l] + qkv_b[l]          new K/V rows -> k_rows[l], v_rows[l]
//   ctx  = softmax(q k^T / sqrt(hd) + mask) v     row s over its slots [0, pos[s]]
//   x   += ctx @ proj_w[l] + proj_b[l]
//   x   += gelu_new(LN2(x) @ fc_w[l] + fc_b[l]) @ mproj_w[l] + mproj_b[l]
//
// and writes x (before ln_f) in the activation type A (bf16 or fp32), the type
// of hidden, the LayerNorm parameters and the biases.  Weights are stacked
// [L, K, N] K-major, plain in A or int8 {q [L, K, N], s fp32 [L, 1, N]}
// ((x @ q) * s, the scale on each column's fp32 sum), as the TPU kernel's
// `supported` allows.  The cache [L, S, T, D] (flat, head-major) is in A or
// fp8 e4m3 and is only read: the new rows go out as k_rows / v_rows
// [L, S, D] in the cache type, and the caller scatters them, as the TPU
// kernel's caller does.  Row s attends its slots [0, pos[s]]: slots past it
// must be masked (the pool's invariant), and the kernel does not read them.
// Slot pos[s] comes from the fp32 qkv rounded to A (trunk_common.cuh).
//
// Bound on the H100 at the flagship width (D=1280, L=24, H=20): a step reads
// every weight once (944.5 MB bf16, 473.8 MB int8) plus each row's live cache
// (2 L (pos+1) D values a row), and does 2 * 12 D^2 L S flops in its products
// (60.4 GFLOP at S=64: 0.90 ms at the 67 TFLOP/s of CUDA-core fp32 FMA).  At
// S=8 the bytes bound it; at S=64 the two are close (bf16 with every row at
// position 700: bytes 1.93 ms; int8 weights over an e4m3 cache: 0.96 ms), so
// which one binds depends on the tier and the rows' positions.  Design,
// simple first:
//   - LayerNorm: one block per row into an fp32 buffer.
//   - Products: one block per (32 output columns, 256 rows of K, up to 64
//     rows of S), so each weight is read from device memory once a step for
//     S <= 64, and hundreds of blocks keep loads in flight.  K is staged
//     through shared memory in tiles of 64 (the weight tile and the rows'
//     inputs as fp32); each lane owns one column and up to 8 rows and sums
//     its k in order.  A second kernel adds the 256-row partial sums in
//     order and applies the scale, bias and epilogue.  The split is fixed by
//     K alone and nothing is atomic: a row's sums do not depend on the other
//     rows, its slot index or S.
//   - Attention: one block per (head, 64-slot chunk, row), as K2's per-row
//     attention; chunks past a row's position exit at once (the grid covers
//     all of T, so the host needs no positions), and a combine kernel joins
//     each row's chunks.
// Twelve kernels a layer.  fp32 residual, LayerNorm (eps 1e-5), softmax and
// every sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_common.cuh"

namespace {

constexpr int kLnThreads = 256;
constexpr int kGemmCols = 32;    // output columns of a block: one per lane
constexpr int kGemmWarps = 8;
constexpr int kMaxRowsPerWarp = 8;
constexpr int kGemmRows = kGemmWarps * kMaxRowsPerWarp;  // rows of a block, at most
constexpr int kTileK = 64;
constexpr int kSplitK = 256;  // rows of K per block; the partial sums add in order

__device__ float ln_block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kLnThreads / 32; ++w) s += red[w];
  return s;
}

// y[row] = LN(x[row]) * scale + bias, one block per row.
template <typename A>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const float* __restrict__ x, const A* __restrict__ scale,
               const A* __restrict__ bias, float* __restrict__ y, int D) {
  __shared__ float red[kLnThreads / 32];
  const float* xr = x + (long long)blockIdx.x * D;
  float* yr = y + (long long)blockIdx.x * D;
  float s = 0.f;
  for (int k = threadIdx.x; k < D; k += kLnThreads) s += xr[k];
  const float mean = ln_block_sum(s, red) / D;
  float q = 0.f;
  for (int k = threadIdx.x; k < D; k += kLnThreads) {
    const float d = xr[k] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(ln_block_sum(q, red) / D + 1e-5f);
  for (int k = threadIdx.x; k < D; k += kLnThreads)
    yr[k] = (xr[k] - mean) * rstd * to_f32(scale[k]) + to_f32(bias[k]);
}

// part[split, s, n] = in[s, k-range] @ W[k-range, n] for this block's 32
// columns, its 256-row K range (blockIdx.y) and its rows (blockIdx.z): warp
// w owns rows row0 + w * rpw + [0, rpw).  in: [S, K] fp32; W: [K, N] in A
// (kPlain) or int8 (kInt8, unscaled).
template <typename A, int kForm>
__global__ void __launch_bounds__(kGemmWarps * 32)
gemm_partial_kernel(const float* __restrict__ in, int S, int K, int N, int rpw,
                    const void* __restrict__ w, float* __restrict__ part) {
  __shared__ __align__(16) float xs[kGemmRows][kTileK];
  __shared__ float wt[kTileK][kGemmCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = kGemmWarps * rpw;
  const int row0 = blockIdx.z * rows;
  const int n0 = blockIdx.x * kGemmCols;
  const int kbeg = blockIdx.y * kSplitK, kend = min(K, kbeg + kSplitK);
  float acc[kMaxRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) acc[r] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kTileK) {
    for (int i = threadIdx.x; i < rows * kTileK; i += kGemmWarps * 32) {
      const int r = i / kTileK, kk = i % kTileK;
      const int s = row0 + r, k = k0 + kk;
      xs[r][kk] = (s < S && k < kend) ? in[(long long)s * K + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kTileK * kGemmCols; i += kGemmWarps * 32) {
      const int kk = i / kGemmCols, c = i % kGemmCols;
      const int k = k0 + kk, n = n0 + c;
      float v = 0.f;
      if (k < kend && n < N) {
        const long long at = (long long)k * N + n;
        if constexpr (kForm == kPlain)
          v = to_f32(static_cast<const A*>(w)[at]);
        else
          v = static_cast<float>(static_cast<const int8_t*>(w)[at]);
      }
      wt[kk][c] = v;
    }
    __syncthreads();
    const float* xw = &xs[warp * rpw][0];
#pragma unroll 2
    for (int kk = 0; kk < kTileK; kk += 4) {
      const float w0 = wt[kk][lane], w1 = wt[kk + 1][lane];
      const float w2 = wt[kk + 2][lane], w3 = wt[kk + 3][lane];
#pragma unroll
      for (int r = 0; r < kMaxRowsPerWarp; ++r) {
        if (r < rpw) {
          const float4 xv = *reinterpret_cast<const float4*>(xw + r * kTileK + kk);
          acc[r] = fmaf(xv.x, w0, acc[r]);
          acc[r] = fmaf(xv.y, w1, acc[r]);
          acc[r] = fmaf(xv.z, w2, acc[r]);
          acc[r] = fmaf(xv.w, w3, acc[r]);
        }
      }
    }
    __syncthreads();
  }

  const int n = n0 + lane;
  if (n >= N) return;
  float* p = part + (long long)blockIdx.y * S * N + n;
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r) {
    const int s = row0 + warp * rpw + r;
    if (r >= rpw || s >= S) break;
    p[(long long)s * N] = acc[r];
  }
}

// out[s, n] (op) sum over splits of part[:, s, n], scaled (kInt8) and
// biased: kStore, kStoreGelu, or kAddTo the residual.  kStore also writes
// columns [D, 2D) and [2D, 3D) to k_rows / v_rows [S, D] in the cache type C.
template <typename A, typename C, int kForm>
__global__ void gemm_epilogue_kernel(const float* __restrict__ part, int n_split, int S, int N,
                                     const float* __restrict__ ws, const A* __restrict__ bias,
                                     float* __restrict__ out, int epi, C* __restrict__ k_rows,
                                     C* __restrict__ v_rows, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * N) return;
  const int s = static_cast<int>(i / N), n = static_cast<int>(i % N);
  float sum = 0.f;
  for (int k = 0; k < n_split; ++k) sum += part[(long long)k * S * N + i];
  if constexpr (kForm == kInt8) sum *= ws[n];
  const float b = to_f32(bias[n]);
  if (epi == kAddTo) {
    out[i] = (out[i] + sum) + b;
  } else {
    const float v = sum + b;
    out[i] = (epi == kStoreGelu) ? gelu_new(v) : v;
    if (k_rows != nullptr && n >= D && n < 2 * D) store(k_rows + (long long)s * D + (n - D), v);
    if (v_rows != nullptr && n >= 2 * D) store(v_rows + (long long)s * D + (n - 2 * D), v);
  }
}

__device__ __forceinline__ int clamp_pos(int p, int T) { return min(max(p, 0), T - 1); }

// Grid (H, ceil(T / 64), S): head, slot chunk, row.  qkv [S, 3D] fp32; kc /
// vc: this layer's cache [S, T, D]; mask [S, T]; partials at
// part[((s * H + h) * n_chunks + chunk) * (2 + hd)].
template <typename A, typename C>
__global__ void __launch_bounds__(kAttnWarps * 32)
attn_rows_kernel(const float* __restrict__ qkv, const C* __restrict__ kc,
                 const C* __restrict__ vc, const int* __restrict__ mask,
                 const int* __restrict__ positions, int D, int T, float scale,
                 float* __restrict__ part) {
  const int h = blockIdx.x, chunk = blockIdx.y, s = blockIdx.z;
  const int pos = clamp_pos(positions[s], T);
  if (chunk * kAttnChunk > pos) return;  // the whole block: no slot of [0, pos] here
  const float* q = qkv + (long long)s * 3 * D;
  const long long row = (long long)s * T * D;
  attn_partial_block<A, C>(
      q, q + D, q + 2 * D, kc + row, vc + row, mask + (long long)s * T, pos, D, scale, h,
      chunk, part + (((long long)s * gridDim.x + h) * gridDim.y + chunk) * (2 + kHeadDim));
}

// Grid (H, S), kHeadDim threads: ctx[s, h * hd + d] over row s's chunks.
__global__ void attn_rows_combine_kernel(const float* __restrict__ part,
                                         const int* __restrict__ positions, int T,
                                         int n_chunks, int D, float* __restrict__ ctx) {
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  const int n_split = clamp_pos(positions[s], T) / kAttnChunk + 1;
  const float* p = part + ((long long)s * gridDim.x + h) * n_chunks * (2 + kHeadDim);
  ctx[(long long)s * D + h * kHeadDim + d] = attn_combine(p, n_split, d);
}

// One stacked matrix: data, and the fp32 column scales of the int8 form.
struct Matrix {
  const void* w;
  const float* s;
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

template <typename A, int kForm>
Matrix layer_of(const Matrix& m, int l, long long K, long long N) {
  if constexpr (kForm == kPlain)
    return {static_cast<const A*>(m.w) + l * K * N, nullptr};
  else
    return {static_cast<const int8_t*>(m.w) + l * K * N, m.s + l * N};
}

template <typename A, typename C, int kForm>
int gemm(cudaStream_t st, const float* in, int S, int K, int N, const Matrix& m, const A* b,
         float* out, int epi, C* k_rows, C* v_rows, int D, float* part) {
  // rows per warp: all S rows in one block up to 64 (each weight read once)
  const int rpw = min(kMaxRowsPerWarp, max(1, (S + kGemmWarps - 1) / kGemmWarps));
  const int rows = kGemmWarps * rpw;
  const int n_split = (K + kSplitK - 1) / kSplitK;
  const dim3 grid((N + kGemmCols - 1) / kGemmCols, n_split, (S + rows - 1) / rows);
  gemm_partial_kernel<A, kForm><<<grid, kGemmWarps * 32, 0, st>>>(in, S, K, N, rpw, m.w, part);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const long long n_out = (long long)S * N;
  gemm_epilogue_kernel<A, C, kForm><<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, st>>>(
      part, n_split, S, N, m.s, b, out, epi, k_rows, v_rows, D);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the partial sums of the widest product of a layer.
long long partial_floats(int S, int D) {
  const long long a = (long long)((D + kSplitK - 1) / kSplitK) * 4 * D;
  const long long b = (long long)((4 * D + kSplitK - 1) / kSplitK) * D;
  return (long long)S * (a > b ? a : b);
}

template <typename A, typename C, int kForm>
int pool_step(const Params& P, const A* hidden, A* out, const C* kc, const C* vc, C* k_rows,
              C* v_rows, const int* positions, const int* mask, int S, int L, int D, int H,
              int T, float* scratch, cudaStream_t st) {
  const long long SD = (long long)S * D;
  float* x = scratch;
  float* hn = x + SD;
  float* qkv = hn + SD;
  float* ctx = qkv + 3 * SD;
  float* hbuf = ctx + SD;
  float* part = hbuf + 4 * SD;  // attention partials, then the products' partial sums
  const int n_chunks = (T + kAttnChunk - 1) / kAttnChunk;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / H));
  int rc;

  to_f32_kernel<A><<<static_cast<unsigned>((SD + 255) / 256), 256, 0, st>>>(hidden, x, static_cast<int>(SD));
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
    const long long layer = (long long)l * S * T * D;

    ln_rows_kernel<A><<<S, kLnThreads, 0, st>>>(x, ln1_s, ln1_b, hn, D);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    if ((rc = gemm<A, C, kForm>(st, hn, S, D, 3 * D, qkv_w, qkv_b, qkv, kStore,
                                k_rows + l * SD, v_rows + l * SD, D, part)))
      return rc;
    attn_rows_kernel<A, C><<<dim3(H, n_chunks, S), kAttnWarps * 32, 0, st>>>(
        qkv, kc + layer, vc + layer, mask, positions, D, T, scale, part);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    attn_rows_combine_kernel<<<dim3(H, S), kHeadDim, 0, st>>>(part, positions, T, n_chunks, D,
                                                              ctx);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    if ((rc = gemm<A, C, kForm>(st, ctx, S, D, D, proj_w, proj_b, x, kAddTo, nullptr,
                                nullptr, D, part)))
      return rc;
    ln_rows_kernel<A><<<S, kLnThreads, 0, st>>>(x, ln2_s, ln2_b, hn, D);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    if ((rc = gemm<A, C, kForm>(st, hn, S, D, 4 * D, fc_w, fc_b, hbuf, kStoreGelu, nullptr,
                                nullptr, D, part)))
      return rc;
    if ((rc = gemm<A, C, kForm>(st, hbuf, S, 4 * D, D, mproj_w, mproj_b, x, kAddTo, nullptr,
                                nullptr, D, part)))
      return rc;
  }
  from_f32_kernel<A><<<static_cast<unsigned>((SD + 255) / 256), 256, 0, st>>>(x, out, static_cast<int>(SD));
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename C>
int dispatch_form(int form, const Params& P, const void* hidden, void* out, const void* k,
                  const void* v, void* k_rows, void* v_rows, const int* positions,
                  const int* mask, int S, int L, int D, int H, int T, float* scratch,
                  cudaStream_t st) {
  const A* h = static_cast<const A*>(hidden);
  A* o = static_cast<A*>(out);
  const C* kc = static_cast<const C*>(k);
  const C* vc = static_cast<const C*>(v);
  C* kr = static_cast<C*>(k_rows);
  C* vr = static_cast<C*>(v_rows);
  switch (form) {
    case kPlain:
      return pool_step<A, C, kPlain>(P, h, o, kc, vc, kr, vr, positions, mask, S, L, D, H, T,
                                     scratch, st);
    case kInt8:
      return pool_step<A, C, kInt8>(P, h, o, kc, vc, kr, vr, positions, mask, S, L, D, H, T,
                                    scratch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Floats of fp32 scratch that pool_trunk_step needs.
extern "C" long long pool_trunk_scratch_floats(int S, int D, int H, int T) {
  const long long attn = (long long)S * H * ((T + kAttnChunk - 1) / kAttnChunk) * (2 + kHeadDim);
  const long long prod = partial_floats(S, D);
  return 10LL * S * D + (attn > prod ? attn : prod);
}

// One pool decode step over all L layers.  act_bf16: hidden, out, LayerNorm
// parameters and biases are bf16 (else fp32); form: 0 plain (weights in the
// activation type), 1 int8 (each matrix: int8 data and fp32 [L, 1, N]
// scales); cache_fp8: the cache and the row outputs are e4m3 (else the
// activation type).  hidden, out: [S, D]; k, v: [L, S, T, D] (read only);
// k_rows, v_rows: [L, S, D]; positions: [S] int32 (clamped to [0, T));
// mask: [S, T] int32.  Requires D / H == 64, S >= 1, T >= 1.  Returns
// cudaGetLastError().
extern "C" int pool_trunk_step(
    int act_bf16, int form, int cache_fp8, const void* hidden, void* out, const void* k,
    const void* v, void* k_rows, void* v_rows, const int* positions, const int* mask, int S,
    int L, int D, int H, int T, const void* ln1_s, const void* ln1_b, const void* qkv_w,
    const float* qkv_s, const void* qkv_b, const void* proj_w, const float* proj_s,
    const void* proj_b, const void* ln2_s, const void* ln2_b, const void* fc_w,
    const float* fc_s, const void* fc_b, const void* mproj_w, const float* mproj_s,
    const void* mproj_b, float* scratch, void* stream) {
  if (H < 1 || D / H != kHeadDim || D % H != 0 || S < 1 || T < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{ln1_s,  ln1_b, {qkv_w, qkv_s},   qkv_b, {proj_w, proj_s},   proj_b,
                 ln2_s,  ln2_b, {fc_w, fc_s},     fc_b,  {mproj_w, mproj_s}, mproj_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    if (cache_fp8)
      return dispatch_form<__nv_bfloat16, fp8_e4m3>(form, P, hidden, out, k, v, k_rows, v_rows,
                                                    positions, mask, S, L, D, H, T, scratch,
                                                    st);
    return dispatch_form<__nv_bfloat16, __nv_bfloat16>(form, P, hidden, out, k, v, k_rows,
                                                       v_rows, positions, mask, S, L, D, H, T,
                                                       scratch, st);
  }
  if (cache_fp8)
    return dispatch_form<float, fp8_e4m3>(form, P, hidden, out, k, v, k_rows, v_rows,
                                          positions, mask, S, L, D, H, T, scratch, st);
  return dispatch_form<float, float>(form, P, hidden, out, k, v, k_rows, v_rows, positions,
                                     mask, S, L, D, H, T, scratch, st);
}
