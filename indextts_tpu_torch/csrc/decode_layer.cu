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
// the qkv product writes the new rows converted to C in place, attention
// upcasts on load, and the token's own slot is read from the fp32 qkv
// rounded to A, as the TPU kernel merges its row into the chunk in the
// compute type.  The products keep fp32 accuracy (trunk_products.cuh says
// why the activations are not rounded to bf16); LayerNorm (eps 1e-5),
// softmax and every sum are fp32; the mask is additive (-1e9 where
// attention_mask is 0).
//
// Bound on the H100: a step reads every weight once (943.7 MB in bf16 at
// D=1280, L=24; ~473 MB int8, ~239 MB int4) plus 2 (pos+1) D cache values a
// layer, against about 2 flops per weight: device memory bandwidth bounds
// it.  Design: the S = 1 case of the product core in trunk_products.cuh
// (tensor-core products over weights streamed 16 bytes a lane, split K
// reduced in-kernel by a ticket, LayerNorm in the prologue) and the
// attention of trunk_common.cuh over 64-slot chunks; 5 L + 2 chained
// launches a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_common.cuh"
#include "trunk_products.cuh"

namespace {

constexpr int kDecodeChunk = 64;  // cache slots per attention block

template <typename A, typename C>
int dispatch_form(int form, const Params& P, const StepIO& io, int L, int D, int H, int T,
                  float* scratch, cudaStream_t s) {
  switch (form) {
    case kPlain:
      return trunk_chain<A, C, kPlain>(P, io, 1, L, D, H, T, scratch, s);
    case kInt8:
      return trunk_chain<A, C, kInt8>(P, io, 1, L, D, H, T, scratch, s);
    case kInt4:
      return trunk_chain<A, C, kInt4>(P, io, 1, L, D, H, T, scratch, s);
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
  return trunk_scratch_floats(1, D, H, T, kDecodeChunk);
}

// One decode step over all L layers, 5 L + 2 chained launches.  act_bf16:
// hidden, out, LayerNorm parameters and biases are bf16 (else fp32); form:
// 0 plain (weights in the activation type), 1 int8, 2 fused int4 (each
// matrix: data, fp32 scales, contraction groups); cache_fp8: the cache is
// e4m3 (else the activation type).  hidden, out: [D]; k, v: [L, T, D] (the
// new rows are written at slot pos, in place); mask: [T] int32.  Requires
// D / H == 64, D % 128 == 0, 0 <= pos < T, and for int4 K / (2 * groups) a
// multiple of 64.  Returns the first launch error, or 0.
extern "C" int decode_trunk_step(
    int act_bf16, int form, int cache_fp8, const void* hidden, void* out, void* k, void* v,
    const int* mask, int pos, int L, int D, int H, int T, const void* ln1_s,
    const void* ln1_b, const void* qkv_w, const float* qkv_s, int qkv_g, const void* qkv_b,
    const void* proj_w, const float* proj_s, int proj_g, const void* proj_b,
    const void* ln2_s, const void* ln2_b, const void* fc_w, const float* fc_s, int fc_g,
    const void* fc_b, const void* mproj_w, const float* mproj_s, int mproj_g,
    const void* mproj_b, float* scratch, void* stream) {
  if (H < 1 || D / H != kHeadDim || D % H || D % kSplitK || pos < 0 || pos >= T || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto half_ok = [](int K, int g) { return g >= 1 && K % (2 * g) == 0 && (K / (2 * g)) % 64 == 0; };
  if (form == kInt4 && !(half_ok(D, qkv_g) && half_ok(D, proj_g) && half_ok(D, fc_g) &&
                         half_ok(4 * D, mproj_g)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{ln1_s, ln1_b, {qkv_w, qkv_s, qkv_g},       qkv_b, {proj_w, proj_s, proj_g},
                 proj_b, ln2_s, ln2_b, {fc_w, fc_s, fc_g}, fc_b,  {mproj_w, mproj_s, mproj_g},
                 mproj_b};
  const size_t csize = cache_fp8 ? 1 : (act_bf16 ? 2 : 4);
  StepIO io{};
  io.hidden = hidden;
  io.out = out;
  io.kc = k;
  io.vc = v;
  io.cache_layer = (long long)T * D;
  io.k_new = static_cast<char*>(k) + (long long)pos * D * csize;  // slot pos of layer 0
  io.v_new = static_cast<char*>(v) + (long long)pos * D * csize;
  io.new_layer = (long long)T * D;
  io.new_ld = 0;
  io.mask = mask;
  io.positions = nullptr;
  io.pos = pos;
  io.attn_chunk = kDecodeChunk;
  io.attn_chunks = pos / kDecodeChunk + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    if (cache_fp8)
      return dispatch_form<__nv_bfloat16, fp8_e4m3>(form, P, io, L, D, H, T, scratch, s);
    return dispatch_form<__nv_bfloat16, __nv_bfloat16>(form, P, io, L, D, H, T, scratch, s);
  }
  if (cache_fp8) return dispatch_form<float, fp8_e4m3>(form, P, io, L, D, H, T, scratch, s);
  return dispatch_form<float, float>(form, P, io, L, D, H, T, scratch, s);
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

// The attention path's fp8 decoding of n_words 16-byte words of e4m3 codes
// (16 floats each), for holding it against torch's cast on all 256 codes.
extern "C" int fp8_e4m3_unpack16(const void* in, float* out, int n_words, void* stream) {
  if (n_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  e4m3_unpack_kernel<<<(n_words + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), out, n_words);
  return static_cast<int>(cudaGetLastError());
}
