// Beam-parent row permutation of the beam decode's suffix KV cache, for
// Hopper (sm_90a): out[l, n] = in[l, rows[n]] for K and V together.
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/permute.py
// (permute_cache_rows, :31; body _copy_kernel, :25).  The cache is
// [L, N, H, T, hd], so each (layer, row) is one contiguous slab of
// H * T * hd elements.  Elements are copied as bytes, 16 at a time, so one
// code path serves bf16, fp32 and fp8 caches; the wrapper checks that a
// slab is a whole number of 16-byte words.
//
// Bound on the H100: a pure copy.  It reads and writes every byte of K and
// V once (471.9 MB at the flagship beam-3 suffix [24, 3, 20, 640, 64] in
// bf16, 0.141 ms at 3.35 TB/s), so device memory bandwidth bounds it.
// Design, simple first: one block per (layer, row, 64 KB piece of the
// slab), neighbouring threads on neighbouring 16-byte words.  rows stays on
// the device (no host sync per step).  The permutation need not be a
// bijection (two children of one parent give rows like [0, 0, 2]), so the
// copy is out of place: the caller keeps a second pair of buffers and swaps.
// Like the TPU kernel it copies all T slots, the unwritten ones included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kWordsPerBlock = 4096;  // 64 KB of each of K and V

__global__ void __launch_bounds__(kThreads)
permute_rows_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                    uint4* __restrict__ k_out, uint4* __restrict__ v_out,
                    const int* __restrict__ rows, int N, long long slab_words) {
  const int l = blockIdx.z, n = blockIdx.y;
  const long long src = ((long long)l * N + rows[n]) * slab_words;
  const long long dst = ((long long)l * N + n) * slab_words;
  const long long start = (long long)blockIdx.x * kWordsPerBlock;
  const long long end = min(start + kWordsPerBlock, slab_words);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    k_out[dst + i] = k[src + i];
    v_out[dst + i] = v[src + i];
  }
}

}  // namespace

// k, v, k_out, v_out: [L, N, slab_bytes] with 16-byte aligned bases; rows: [N]
// int32 on the device, each in [0, N) (not checked: that would need a host
// sync).  k_out and v_out must not overlap k and v.  Returns
// cudaGetLastError().
extern "C" int permute_cache_rows(const void* k, const void* v, void* k_out, void* v_out,
                                  const int* rows, int L, int N, long long slab_bytes,
                                  void* stream) {
  if (L <= 0 || N <= 0 || slab_bytes <= 0 || slab_bytes % 16 || L > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long words = slab_bytes / 16;
  const dim3 grid(static_cast<unsigned>((words + kWordsPerBlock - 1) / kWordsPerBlock), N, L);
  permute_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v), static_cast<uint4*>(k_out),
      static_cast<uint4*>(v_out), rows, N, words);
  return static_cast<int>(cudaGetLastError());
}
