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
// (60.4 GFLOP at S=64: 0.06 ms on the tensor cores): bytes bind it at every
// S <= 64.  Design: the product core of trunk_products.cuh (one pass over
// the weights for all S <= 64 rows, tensor-core products on 16-row tiles
// at fp32 accuracy, split K fixed by K alone and reduced in-kernel in split order, so a
// row's numbers depend neither on S nor on its slot; LayerNorm folded into
// the prologue from tile statistics the residual's writers leave) and the
// attention of trunk_common.cuh: a block per (head, 128-slot chunk, row)
// streaming the row's live cache 16 bytes a lane, blocks past the row's
// position exiting at once (the grid covers all of T, so the host needs no
// positions), and the last chunk block of a (row, head) joining the chunks.
// 5 L + 2 chained launches a step; more than 64 rows run as independent
// slices of 64 (rows never mix), each slice its own chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_common.cuh"
#include "trunk_products.cuh"

namespace {

constexpr int kPoolChunk = 128;  // cache slots per attention block

template <typename A, typename C>
int dispatch_form(int form, const Params& P, const StepIO& io, int S, int L, int D, int H,
                  int T, float* scratch, cudaStream_t st) {
  switch (form) {
    case kPlain:
      return trunk_chain<A, C, kPlain>(P, io, S, L, D, H, T, scratch, st);
    case kInt8:
      return trunk_chain<A, C, kInt8>(P, io, S, L, D, H, T, scratch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Floats of fp32 scratch that pool_trunk_step needs.
extern "C" long long pool_trunk_scratch_floats(int S, int D, int H, int T) {
  return trunk_scratch_floats(S < kMaxRows ? S : kMaxRows, D, H, T, kPoolChunk);
}

// One pool decode step over all L layers.  act_bf16: hidden, out, LayerNorm
// parameters and biases are bf16 (else fp32); form: 0 plain (weights in the
// activation type), 1 int8 (each matrix: int8 data and fp32 [L, 1, N]
// scales); cache_fp8: the cache and the row outputs are e4m3 (else the
// activation type).  hidden, out: [S, D]; k, v: [L, S, T, D] (read only);
// k_rows, v_rows: [L, S, D]; positions: [S] int32 (clamped to [0, T));
// mask: [S, T] int32.  Requires D / H == 64, D % 128 == 0, S >= 1, T >= 1.
// Returns the first launch error, or 0.
extern "C" int pool_trunk_step(
    int act_bf16, int form, int cache_fp8, const void* hidden, void* out, const void* k,
    const void* v, void* k_rows, void* v_rows, const int* positions, const int* mask, int S,
    int L, int D, int H, int T, const void* ln1_s, const void* ln1_b, const void* qkv_w,
    const float* qkv_s, const void* qkv_b, const void* proj_w, const float* proj_s,
    const void* proj_b, const void* ln2_s, const void* ln2_b, const void* fc_w,
    const float* fc_s, const void* fc_b, const void* mproj_w, const float* mproj_s,
    const void* mproj_b, float* scratch, void* stream) {
  if (H < 1 || D / H != kHeadDim || D % H != 0 || D % kSplitK || S < 1 || T < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{ln1_s,  ln1_b, {qkv_w, qkv_s, 1},   qkv_b, {proj_w, proj_s, 1},   proj_b,
                 ln2_s,  ln2_b, {fc_w, fc_s, 1},     fc_b,  {mproj_w, mproj_s, 1}, mproj_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t asize = act_bf16 ? 2 : 4, csize = cache_fp8 ? 1 : asize;
  for (int s0 = 0; s0 < S; s0 += kMaxRows) {
    const int n = S - s0 < kMaxRows ? S - s0 : kMaxRows;
    StepIO io{};
    io.hidden = static_cast<const char*>(hidden) + (long long)s0 * D * asize;
    io.out = static_cast<char*>(out) + (long long)s0 * D * asize;
    io.kc = static_cast<const char*>(k) + (long long)s0 * T * D * csize;
    io.vc = static_cast<const char*>(v) + (long long)s0 * T * D * csize;
    io.cache_layer = (long long)S * T * D;
    io.k_new = static_cast<char*>(k_rows) + (long long)s0 * D * csize;
    io.v_new = static_cast<char*>(v_rows) + (long long)s0 * D * csize;
    io.new_layer = (long long)S * D;
    io.new_ld = D;
    io.mask = mask + (long long)s0 * T;
    io.positions = positions + s0;
    io.pos = 0;
    io.attn_chunk = kPoolChunk;
    io.attn_chunks = (T + kPoolChunk - 1) / kPoolChunk;
    int rc;
    if (act_bf16)
      rc = cache_fp8 ? dispatch_form<__nv_bfloat16, fp8_e4m3>(form, P, io, n, L, D, H, T,
                                                              scratch, st)
                     : dispatch_form<__nv_bfloat16, __nv_bfloat16>(form, P, io, n, L, D, H, T,
                                                                   scratch, st);
    else
      rc = cache_fp8 ? dispatch_form<float, fp8_e4m3>(form, P, io, n, L, D, H, T, scratch, st)
                     : dispatch_form<float, float>(form, P, io, n, L, D, H, T, scratch, st);
    if (rc) return rc;
  }
  return 0;
}
