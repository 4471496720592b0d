// The product core shared by the decode-trunk kernels for Hopper (sm_90a),
// K2 (decode_layer.cu, S = 1) and K4 (pool_trunk.cu, S <= 64), and the
// chain of launches of one trunk step that both run.
//
// A product computes out[s, n] = epilogue(sum_k a[s, k] W[k, n]) for S rows,
// with W one layer of a stacked [L, K, N] K-major matrix in one of three
// forms (kForm): plain in A; int8 {q, s} with the scale on each column's
// fp32 sum; fused int4 {q4, s} (byte row j of group g holds row 2gh + j in
// its low nibble and 2gh + h + j in its high one, h = K / 2G; the two halves
// scale by rows 2g and 2g + 1 of s, per half and column, before the half's
// sum joins the column's).
//
// What bounds it on the H100: at S <= 64 a product reads each weight once
// and does 2 S flops on it, far below the 295 flops a byte at which the
// tensor cores would bind: bytes bind.  The design streams every weight
// byte once, 16 bytes a lane:
//   - One block (4 warps) per (32 output columns, 128 rows of K); for int4
//     the 128 rows are 64 byte rows, both halves.  The split is fixed by K
//     alone (K / 128 splits), so a row's sums never depend on S, its slot or
//     the card.  At one row (K2) a block takes four adjacent column tiles,
//     a warp each, where that leaves at least two blocks an SM (264 on the
//     H100's 132; the count is read from the device): qkv, fc and mproj
//     get 300-400 blocks, proj 400 of one tile.  At more rows (K4) a block
//     takes one tile (four warps of 8 columns): 400-1600 blocks.
//   - Before it waits on the previous kernel, a block issues its whole
//     weight tile (8 KB a tile in bf16, 4 KB int8, 2 KB int4) as four
//     stages of 16-byte cp.async.cg copies, neighbouring lanes on
//     neighbouring 16 bytes, 24-160 KB a SM in flight.  Each stage is
//     consumed as it lands (cp.async.wait_group).
//   - In bf16 the products run on the tensor cores: mma.sync m16n8k16 bf16
//     with fp32 sums, on 16-row slabs of the activations (rows past S
//     zeroed), A from ldmatrix, plain weights through ldmatrix.trans from a
//     swizzled tile, int8 and int4 weights converted to bf16 in registers
//     (exact: |q| <= 127).  With four tiles a block (one row) a lane reads
//     the quantized weights as 32-bit words, four columns of a row, from a
//     tile swizzled so that a load's four rows sit on distinct banks; the
//     mma columns of the warp's four 8-column slices are permuted (slice q,
//     column j is column 4 j + q) so that one word feeds all four slices.
//     The activations are NOT rounded to bf16 as the
//     TPU kernels round them: each fp32 value is split into a bf16 pair
//     hi + lo (to 2^-17) and both halves go through the tensor cores, so the
//     products keep fp32 accuracy.  Rounding them was tried first: with the
//     plain version rounding the same way, two implementations that differ
//     only in the order of fp32 sums disagree by about one bf16 ulp of the
//     output after 24 layers (the flips of bf16 roundings compound), which
//     is the tolerance of the card's checks.  Each step of 16 products is
//     summed by the tensor core from zero and joins the running sum with a
//     round-to-nearest add.  Each output element is its own dot, so a row's
//     value does not depend on the other rows.  In fp32 (the fp32 checks)
//     the products are fp32 FMA.
//   - The split reduces inside the same kernel: each block writes its
//     partial sums, and the last block of a column tile to finish (a
//     ticket: a barrier, then an acq_rel atomicAdd on the tile's counter,
//     the only atomic) stages the tile's partial sums in shared memory with
//     16-byte loads, adds them in split order and applies scale, bias and
//     the epilogue: store, gelu_new, add to the fp32 residual (and write
//     that row's LayerNorm statistics), or, for qkv, also the new K/V rows
//     in the cache type.  It resets the counter for the next product.
//   - LayerNorm is folded into the prologue: the writers of the residual
//     leave per-32-column {mean, M2} tiles, and each block joins a row's
//     tiles in a fixed tree (a warp a row) and normalizes only its 128 rows
//     of K.  That costs S * D / 16 floats from L2 a block, where recomputing
//     the statistics from x would cost S * D (25x more at D = 1280), and it
//     saves a LayerNorm kernel twice a layer.
//
// One step is 5 L + 2 launches: the input conversion (which also zeroes the
// tickets), then per layer qkv (LN1 prologue, K/V-row epilogue), attention
// (trunk_common.cuh; its last block per (row, head) joins the chunks, so
// proj reads a plain context: joining them in proj's prologue would repeat
// the join for every one of its 40 column tiles), proj (+= residual), fc
// (LN2 prologue, gelu) and mproj (+= residual), and the output conversion.
// Every launch is chained (launch_pdl): the next product's weight copies
// overlap the drain of the kernel before it.  Nothing of the scratch is
// touched before pdl_wait(), so neighbouring kernels cannot race on it;
// each phase has its own buffer all the same (partial sums, attention
// partials, statistics, tickets).
//
// Tried on the card (tools/trunk_ab.py, PERF.md): an L2 prefetch of the
// next product's weights (cp.async.bulk.prefetch.L2) made the bf16 step 7%
// slower and went; four tiles a block (a warp each) made the one-row step
// 20% faster in bf16, 7% in int4, 1% in int8, and the pool step slower, so
// only one row takes them.  Quantized weights are read by words because
// one byte a slice (16 byte loads a k-step, 4-way bank conflicts) left the
// int8 and int4 steps slower than bf16's, and the block's shared memory is
// sized for the tail's staging so that int4's mproj takes four tiles too.
// The step is bound by each kernel's chain of dependent latencies more than
// by bytes: int4 moves a quarter of bf16's bytes and is only a little faster.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trunk_common.cuh"

namespace {

constexpr int kProdThreads = 128;  // 4 warps, one 8-column slice each
constexpr int kProdCols = 32;      // columns of a tile (one LayerNorm statistics tile)
constexpr int kSplitK = 128;       // rows of K a block; K / kSplitK splits
constexpr int kStages = 4;
constexpr int kMaxRows = 64;       // S, at most
constexpr int kApad = 8;           // bf16 A-tile row padding (ldmatrix rows on distinct banks)
constexpr int kMaxTiles = 4;       // 32-column tiles a block, at most: one a warp

static_assert(kProdCols == kStatCols, "LayerNorm statistics are kept per column tile");

enum Epilogue { kStore = 0, kStoreGelu = 1, kAddTo = 2 };

template <typename A, int kForm>
struct Tile {
  // bytes of one stored weight row of the block's 32 columns, and its rows
  static constexpr int kRowBytes =
      kForm == kPlain ? kProdCols * static_cast<int>(sizeof(A)) : kProdCols;
  static constexpr int kRows = kForm == kInt4 ? kSplitK / 2 : kSplitK;
  static constexpr int kWeightBytes = kRowBytes * kRows;
  static constexpr bool kSwizzle = kForm == kPlain && sizeof(A) == 2;
  // int8 and int4 in bf16 with kMaxTiles tiles: a lane reads 32-bit words
  // (four columns of a row) and its mma columns are permuted to match
  static constexpr bool kWords = kForm != kPlain && sizeof(A) == 2;
  static constexpr int kAld = sizeof(A) == 2 ? kSplitK + kApad : kSplitK + 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void wait_stage(int st) {  // stages after st may stay in flight
  switch (kStages - 1 - st) {
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// acc += one k16 step's product of A fragments (hi + lo) with b, the step's
// sum taken from zero on the tensor core and joined with a round-to-nearest add.
__device__ __forceinline__ void mma_pair(float* acc, const uint32_t* a_hi, const uint32_t* a_lo,
                                         const uint32_t* b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(c, a_hi, b);
  mma_bf16(c, a_lo, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The signed nibbles at bit `shift` of bytes b0 and b1 as a bf16 pair, by
// bits: v + 8 (the nibble with its sign bit flipped) in the mantissa of
// 128.0 is 136 + v exactly, and one bf16 subtraction leaves v.
__device__ __forceinline__ uint32_t nib_pair_bf16(uint32_t n) {  // nibbles at bits 0 and 16
  uint32_t bits = (n ^ 0x00080008u) | 0x43004300u;
  __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  x = __hsub2(x, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ uint32_t nibs_bf16(int8_t b0, int8_t b1, int shift) {
  return nib_pair_bf16(((static_cast<uint32_t>(b0) >> shift) & 0xFu) |
                       (((static_cast<uint32_t>(b1) >> shift) & 0xFu) << 16));
}
// The same of byte q of the words x and y (one permute gathers both bytes).
__device__ __forceinline__ uint32_t nibs_bf16_w(uint32_t x, uint32_t y, int q, int shift) {
  const uint32_t sel = q | (q << 4) | ((4 + q) << 8) | ((4 + q) << 12);
  return nib_pair_bf16((__byte_perm(x, y, sel) >> shift) & 0x000F000Fu);
}
__device__ __forceinline__ float nib_lo(int8_t b) {
  return static_cast<float>(static_cast<int32_t>(static_cast<uint32_t>(b) << 28) >> 28);
}
__device__ __forceinline__ float nib_hi(int8_t b) {
  return static_cast<float>(static_cast<int32_t>(static_cast<uint32_t>(b) << 24) >> 28);
}

struct ProductArgs {
  const float* in;         // [S, K] fp32 activations
  const float2* stats_in;  // [S, K / 32] LayerNorm tile statistics, or null (no LayerNorm)
  const void* ln_s;        // [K] in A
  const void* ln_b;
  const void* w;           // this layer's weight in form kForm
  const float* ws;         // int8: [N]; int4: [2G, N]
  int groups;              // int4 contraction groups
  const void* bias;        // [N] in A
  float* out;              // [S, N]
  int S, K, N, epi;
  float* part;             // [K / kSplitK, S, N] partial sums
  int* counters;           // [N / 32] tickets, zero between products
  float2* stats_out;       // kAddTo: [S, N / 32]
  void* k_new;             // kStore with N == 3 D: new K/V rows in C at k_new + s * kv_ld
  void* v_new;
  long long kv_ld;
  int D;
  int stage_floats;        // floats of the block's shared memory (the tail stages partials there)
};

// Stored row r of the block (byte row for int4), 16-byte chunk c -> its
// place in the shared weight tile of `tiles` 32-column tiles.  bf16 rows are
// swizzled so that the 8 rows an ldmatrix phase reads sit on distinct banks;
// int8 and int4 rows of kMaxTiles tiles so that the four rows a word load
// reads (2 t, 2 t + 1, 2 t + 8, 2 t + 9 of a k-step) do.
template <typename A, int kForm>
__device__ __forceinline__ int tile_offset(int r, int c, int tiles) {
  using T = Tile<A, kForm>;
  if constexpr (T::kSwizzle) c ^= tiles == 1 ? (r >> 1) & 3 : r & 7;
  if constexpr (T::kWords) c ^= tiles == kMaxTiles ? ((r >> 1) & 3) << 1 : 0;
  return (r * tiles) * T::kRowBytes + c * 16;
}

// Moments of a run of values: count, mean, sum of squared deviations.
struct Moments {
  float n, mean, m2;
};
// Chan's rule for joining two runs (a before b).
__device__ __forceinline__ Moments join(const Moments& a, const Moments& b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, delta = b.mean - a.mean, f = b.n / n;
  return {n, a.mean + delta * f, a.m2 + b.m2 + delta * delta * a.n * f};
}
// {mean, rstd} of a row from its n_tiles tile statistics, on every lane of
// the warp: lane t joins tiles t, t + 32, ..., then the lanes join pairwise
// in a fixed tree (the lower lane first, so both lanes of a pair agree).
__device__ __forceinline__ float2 row_mean_rstd(const float2* __restrict__ st, int n_tiles) {
  const int lane = threadIdx.x & 31;
  Moments m{0.f, 0.f, 0.f};
  for (int t = lane; t < n_tiles; t += 32) {
    const float2 v = __ldcg(st + t);
    m = join(m, {static_cast<float>(kStatCols), v.x, v.y});
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Moments o{__shfl_xor_sync(0xffffffffu, m.n, off),
                    __shfl_xor_sync(0xffffffffu, m.mean, off),
                    __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = (lane & off) ? join(o, m) : join(m, o);
  }
  return make_float2(m.mean, rsqrtf(m.m2 / m.n + 1e-5f));
}

// Grid (N / (32 kTiles), K / kSplitK), kProdThreads threads: the block's
// kTiles adjacent 32-column tiles over one split.  With one tile, warp w
// owns its columns 8 w .. 8 w + 7; with kMaxTiles, warp w owns tile w (four
// 8-column slices, four independent sums in flight).  kMt: 16-row tiles of
// the tensor-core path (1 for S = 1, else 4); the fp32 path ignores it.
template <typename A, typename C, int kForm, int kMt, int kTiles>
__global__ void __launch_bounds__(kProdThreads,
                                  kTiles > 1 ? 5 : (sizeof(A) == 2 ? (kMt == 1 ? 12 : 8) : 4))
product_kernel(const ProductArgs p) {
  using T = Tile<A, kForm>;
  static_assert(kSplitK == kProdThreads, "thread tid owns column tid of the A tile");
  constexpr bool kTensor = sizeof(A) == 2;
  constexpr int kAcc = kTensor ? kMt : 4;
  // quantized weights by words: slice q's mma column j is column 4 j + q of
  // the warp's 32, so a lane's four slices share one word a row
  constexpr bool kByWords = T::kWords && kTiles == kMaxTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 row_ln[kMaxRows];
  __shared__ float col_bias[kMaxTiles * kProdCols], col_scale[kMaxTiles * kProdCols];
  __shared__ float col_slo[kMaxTiles * kProdCols], col_shi[kMaxTiles * kProdCols];
  __shared__ int last_mask;
  constexpr int tiles = kTiles;
  const int S = p.S, K = p.K, N = p.N;
  unsigned char* wt = smem;                                          // [kRows][tiles * kRowBytes]
  A* at = reinterpret_cast<A*>(smem + tiles * T::kWeightBytes);      // [Mt * 16][kAld] (hi)
  A* at_lo = at + (S + 15) / 16 * 16 * T::kAld;                      // bf16: the low parts
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile0 = blockIdx.x * tiles, split = blockIdx.y, n_split = gridDim.y;
  const int nb0 = tile0 * kProdCols;  // the block's first column
  const int width = tiles * kProdCols;
  // this warp's columns in the block: n_sub 8-column slices from cbase
  constexpr int n_sub = kTiles;  // 8-column slices a warp
  const int cbase = kTiles == 1 ? 8 * warp : kProdCols * warp;

  // 1. before waiting on the previous kernel, what no kernel of the step
  // writes: the weight tile (four stages of 16-byte copies over its rows),
  // this thread's LayerNorm parameters, and the columns' scales and biases
  const int row0 = split * T::kRows;  // first stored row (byte row for int4)
  {
    const int chunks = tiles * T::kRowBytes / 16;  // per stored row
    constexpr int kRowsPerStage = T::kRows / kStages;
    const unsigned char* wg = static_cast<const unsigned char*>(p.w);
    const int elem = kForm == kPlain ? static_cast<int>(sizeof(A)) : 1;
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      for (int i = tid; i < kRowsPerStage * chunks; i += kProdThreads) {
        const int r = st * kRowsPerStage + i / chunks, c = i % chunks;
        cp_async16(wt + tile_offset<A, kForm>(r, c, tiles),
                   wg + ((long long)(row0 + r) * N + nb0) * elem + c * 16);
      }
      cp_async_commit();
    }
  }
  int g = 0, jr0 = 0, half = 0;
  if constexpr (kForm == kInt4) {
    half = K / (2 * p.groups);
    g = row0 / half;
    jr0 = row0 - g * half;
  }
  // column tid of the A tile is row k_of of K
  int k_of;
  if constexpr (kForm == kInt4)
    k_of = 2 * g * half + (tid < kSplitK / 2 ? jr0 + tid : half + jr0 + tid - kSplitK / 2);
  else
    k_of = split * kSplitK + tid;
  float ln_sk = 1.f, ln_bk = 0.f;
  if (p.stats_in != nullptr) {
    ln_sk = to_f32(static_cast<const A*>(p.ln_s)[k_of]);
    ln_bk = to_f32(static_cast<const A*>(p.ln_b)[k_of]);
  }
  if (tid < width) {
    const int n = nb0 + tid;
    col_bias[tid] = to_f32(static_cast<const A*>(p.bias)[n]);
    if constexpr (kForm == kInt8) col_scale[tid] = p.ws[n];
    if constexpr (kForm == kInt4) {
      col_slo[tid] = p.ws[(long long)(2 * g) * N + n];
      col_shi[tid] = p.ws[(long long)(2 * g + 1) * N + n];
    }
  }

  pdl_wait();
  pdl_launch_dependents();

  // 2. the activations, LayerNorm'd if asked, as bf16 pairs hi + lo (fp32:
  // as they are), rows past S zero: thread tid fills column tid
  const int Mt = (S + 15) / 16;
  constexpr int kBatch = 8;  // loads in flight a thread
  float v[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) v[j] = j < S ? p.in[(long long)j * K + k_of] : 0.f;
  if (p.stats_in != nullptr) {
    for (int s = warp; s < S; s += kProdThreads / 32) {
      const float2 ln = row_mean_rstd(p.stats_in + (long long)s * (K / kStatCols), K / kStatCols);
      if (lane == 0) row_ln[s] = ln;
    }
    __syncthreads();
  }
  for (int s0 = 0; s0 < Mt * 16; s0 += kBatch) {
    if (s0 > 0) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = s0 + j < S ? p.in[(long long)(s0 + j) * K + k_of] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = s0 + j;
      float x = v[j];
      if (s < S && p.stats_in != nullptr)
        x = (x - row_ln[s].x) * row_ln[s].y * ln_sk + ln_bk;
      store(at + s * T::kAld + tid, x);
      if constexpr (kTensor) store(at_lo + s * T::kAld + tid, x - round_to<A>(x));
    }
  }

  // 3. the products, stage by stage as the weights land
  float acc[kTiles][kAcc][4], acc_hi[kTiles][kAcc][4];
#pragma unroll
  for (int q = 0; q < kTiles; ++q)
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][i][e] = acc_hi[q][i][e] = 0.f;
  constexpr int kRowsPerStage = T::kRows / kStages;
  for (int st = 0; st < kStages; ++st) {
    wait_stage(st);
    __syncthreads();
    if constexpr (kTensor) {
#pragma unroll
      for (int ks = 0; ks < kRowsPerStage; ks += 16) {
        const int r0 = st * kRowsPerStage + ks;  // stored row of this k-step
        // kByWords: the words of rows r, r + 1, r + 8, r + 9 holding columns
        // cbase + 4 g .. + 3 (g = lane / 4), one word for all four slices
        uint32_t x0 = 0, x1 = 0, x2 = 0, x3 = 0;
        if constexpr (kByWords) {
          const int r = r0 + (lane & 3) * 2, c16 = (cbase >> 4) + (lane >> 4);
          auto word = [&](int row) {
            return *reinterpret_cast<const uint32_t*>(
                wt + tile_offset<A, kForm>(row, c16, tiles) + 4 * ((lane >> 2) & 3));
          };
          x0 = word(r);
          x1 = word(r + 1);
          x2 = word(r + 8);
          x3 = word(r + 9);
        }
#pragma unroll
        for (int mt = 0; mt < kAcc; ++mt) {
          if (mt >= Mt) break;
          const int off = (mt * 16 + (lane & 15)) * T::kAld + r0 + (lane >> 4) * 8;
          uint32_t a_hi[4], a_lo[4], h_hi[4], h_lo[4];
          ldmatrix_x4(a_hi, at + off);
          ldmatrix_x4(a_lo, at_lo + off);
          if constexpr (kForm == kInt4) {
            ldmatrix_x4(h_hi, at + off + kSplitK / 2);
            ldmatrix_x4(h_lo, at_lo + off + kSplitK / 2);
          }
#pragma unroll
          for (int q = 0; q < n_sub; ++q) {
            const int c8 = cbase + 8 * q;  // this slice's first column in the block
            uint32_t b[2], b_hi[2];
            if constexpr (kForm == kPlain) {
              ldmatrix_x2_trans(b, wt + tile_offset<A, kForm>(r0 + (lane & 15), c8 / 8, tiles));
            } else if constexpr (kByWords) {  // byte q of each word
              if constexpr (kForm == kInt8) {
                b[0] = pack_bf16(static_cast<int8_t>(x0 >> 8 * q), static_cast<int8_t>(x1 >> 8 * q));
                b[1] = pack_bf16(static_cast<int8_t>(x2 >> 8 * q), static_cast<int8_t>(x3 >> 8 * q));
              } else {
                b[0] = nibs_bf16_w(x0, x1, q, 0);
                b[1] = nibs_bf16_w(x2, x3, q, 0);
                b_hi[0] = nibs_bf16_w(x0, x1, q, 4);
                b_hi[1] = nibs_bf16_w(x2, x3, q, 4);
              }
            } else {
              const int n = c8 + (lane >> 2), r = r0 + (lane & 3) * 2;
              const int8_t* w8 = reinterpret_cast<const int8_t*>(wt);
              const int8_t q0 = w8[r * width + n], q1 = w8[(r + 1) * width + n];
              const int8_t q2 = w8[(r + 8) * width + n], q3 = w8[(r + 9) * width + n];
              if constexpr (kForm == kInt8) {
                b[0] = pack_bf16(q0, q1);
                b[1] = pack_bf16(q2, q3);
              } else {
                b[0] = nibs_bf16(q0, q1, 0);
                b[1] = nibs_bf16(q2, q3, 0);
                b_hi[0] = nibs_bf16(q0, q1, 4);
                b_hi[1] = nibs_bf16(q2, q3, 4);
              }
            }
            mma_pair(acc[q][mt], a_hi, a_lo, b);
            if constexpr (kForm == kInt4) mma_pair(acc_hi[q][mt], h_hi, h_lo, b_hi);
          }
        }
      }
    } else {
      // fp32 FMA: lane owns column cbase + 8 q + lane % 8 of each slice q,
      // and rows lane / 8 + 4 i
      const int rg = lane >> 3;
      for (int r = st * kRowsPerStage; r < (st + 1) * kRowsPerStage; ++r) {
#pragma unroll
        for (int q = 0; q < n_sub; ++q) {
          const int c = cbase + 8 * q + (lane & 7);
          float wv, wv_hi = 0.f;
          if constexpr (kForm == kPlain) {
            wv = reinterpret_cast<const float*>(wt + r * tiles * T::kRowBytes)[c];
          } else {
            const int8_t w = reinterpret_cast<const int8_t*>(wt)[r * width + c];
            wv = kForm == kInt8 ? static_cast<float>(w) : nib_lo(w);
            wv_hi = nib_hi(w);
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int s = rg + 4 * i;
            if (s < S) {
              const A* ar = at + s * T::kAld;
              acc[q][i >> 2][i & 3] = fmaf(to_f32(ar[r]), wv, acc[q][i >> 2][i & 3]);
              if constexpr (kForm == kInt4)
                acc_hi[q][i >> 2][i & 3] = fmaf(to_f32(ar[r + kSplitK / 2]), wv_hi,
                                                acc_hi[q][i >> 2][i & 3]);
            }
          }
        }
      }
    }
  }

  // 4. this split's partial sums (int4: each half scaled first)
  float* part = p.part + (long long)split * S * N + nb0;
  auto put = [&](int s, int c, float x, float x_hi) {
    if (s >= S) return;
    if constexpr (kForm == kInt4) x = x * col_slo[c] + x_hi * col_shi[c];
    part[(long long)s * N + c] = x;
  };
  if constexpr (kByWords) {
    // the lane holds columns cbase + 8 t .. + 7 (t = lane % 4; column
    // 8 t + 4 i + q in acc[q][mt][i], row s + 8 in i + 2): two 16-byte stores a row
    const int c0 = cbase + 8 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < kAcc; ++mt) {
      if (mt >= Mt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = mt * 16 + (lane >> 2) + 8 * h;
        if (s >= S) continue;
        float o[8];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < n_sub; ++q) {
            const int c = c0 + 4 * i + q;
            float x = acc[q][mt][2 * h + i];
            if constexpr (kForm == kInt4)
              x = x * col_slo[c] + acc_hi[q][mt][2 * h + i] * col_shi[c];
            o[4 * i + q] = x;
          }
        float4* dst = reinterpret_cast<float4*>(part + (long long)s * N + c0);
        dst[0] = make_float4(o[0], o[1], o[2], o[3]);
        dst[1] = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < n_sub; ++q) {
      if constexpr (kTensor) {
        const int c = cbase + 8 * q + (lane & 3) * 2;
#pragma unroll
        for (int mt = 0; mt < kAcc; ++mt) {
          if (mt >= Mt) break;
          const int s = mt * 16 + (lane >> 2);
          put(s, c, acc[q][mt][0], acc_hi[q][mt][0]);
          put(s, c + 1, acc[q][mt][1], acc_hi[q][mt][1]);
          put(s + 8, c, acc[q][mt][2], acc_hi[q][mt][2]);
          put(s + 8, c + 1, acc[q][mt][3], acc_hi[q][mt][3]);
        }
      } else {
        const int c = cbase + 8 * q + (lane & 7), rg = lane >> 3;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          put(rg + 4 * i, c, acc[q][i >> 2][i & 3], acc_hi[q][i >> 2][i & 3]);
      }
    }
  }

  // 5. a ticket per tile (take_ticket's rule, one counter per tile): the
  // block that finishes a tile's last split adds the tile's splits
  __syncthreads();
  if (tid == 0) last_mask = 0;
  __syncthreads();
  if (tid < tiles) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(p.counters + tile0 + tid)
                 : "memory");
    if (old == n_split - 1) {
      p.counters[tile0 + tid] = 0;
      atomicOr(&last_mask, 1 << tid);
    }
  }
  __syncthreads();
  const int mine = last_mask;
  if (mine == 0) return;

  // 6. the tiles this block finished, each by a team of warps (all four for
  // one tile a block, else warp j for tile j): a group of rows' partial sums
  // is staged in the team's share of shared memory with 16-byte loads, all
  // in flight together; then lane = column, the team's warps take its rows
  // and add their splits in order
  const int team = tiles == 1 ? 4 : 1;        // warps a tile
  const int j = tiles == 1 ? 0 : warp;        // this warp's tile
  if (!(mine & (1 << j))) return;
  const int rank = tiles == 1 ? warp : 0;     // warp within the team
  auto sync_team = [&]() {
    if (tiles == 1) __syncthreads(); else __syncwarp();
  };
  float* buf = reinterpret_cast<float*>(smem) + (p.stage_floats / kMaxTiles) * (tiles == 1 ? 0 : j);
  const int buf_floats = tiles == 1 ? p.stage_floats : p.stage_floats / kMaxTiles;
  const int per_row = n_split * kProdCols;  // floats of one row's partial sums
  const int group = max(1, min(S, buf_floats / per_row));
  const int tile = tile0 + j, n0 = tile * kProdCols, n = n0 + lane;
  const float bias_n = col_bias[j * kProdCols + lane];
  const float scale_n = kForm == kInt8 ? col_scale[j * kProdCols + lane] : 1.f;
  const int tt = team * 32, ti = rank * 32 + lane;  // team threads, this thread's index
  for (int r0 = 0; r0 < S; r0 += group) {
    const int rows = min(group, S - r0);
    const int words = rows * n_split * (kProdCols / 4);
#pragma unroll 4
    for (int i = ti; i < words; i += tt) {
      const int c4 = i % (kProdCols / 4), rs = i / (kProdCols / 4);
      const int sp = rs % n_split, r = rs / n_split;
      reinterpret_cast<float4*>(buf)[i] = __ldcg(reinterpret_cast<const float4*>(
          p.part + ((long long)sp * S + r0 + r) * N + n0) + c4);
    }
    sync_team();
    for (int r = rank; r < rows; r += team) {
      const int s = r0 + r;
      float total = 0.f;
      for (int sp = 0; sp < n_split; ++sp) total += buf[(r * n_split + sp) * kProdCols + lane];
      if constexpr (kForm == kInt8) total *= scale_n;
      float* o = p.out + (long long)s * N + n;
      if (p.epi == kAddTo) {
        const float x = (*o + total) + bias_n;
        *o = x;
        const float2 stt = tile_stats(x);
        if (lane == 0) p.stats_out[(long long)s * (N / kStatCols) + tile] = stt;
      } else {
        const float x = total + bias_n;
        *o = p.epi == kStoreGelu ? gelu_new(x) : x;
        if (p.k_new != nullptr && n >= p.D) {
          C* dst = static_cast<C*>(n < 2 * p.D ? p.k_new : p.v_new);
          store(dst + s * p.kv_ld + (n - (n < 2 * p.D ? p.D : 2 * p.D)), x);
        }
      }
    }
    sync_team();
  }
}

// ---- one trunk step ---------------------------------------------------------

// One stacked matrix: its data, the fp32 scales of a quantized form, and
// the contraction groups of an int4 one.
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

// Where a step reads its cache and writes its new K/V rows (in elements of
// the cache type): layer l of the cache at kc + l * cache_layer, row s of it
// at + s * T * D; the new rows of layer l at k_new + l * new_layer + s * new_ld.
struct StepIO {
  const void* hidden;  // [S, D] in A
  void* out;
  const void *kc, *vc;
  long long cache_layer;
  void *k_new, *v_new;
  long long new_layer, new_ld;
  const int* mask;       // [S, T]
  const int* positions;  // [S] on the device, or null: `pos` for the one row
  int pos;
  int attn_chunk;        // slots per attention block
  int attn_chunks;       // attention blocks a (row, head): the grid's y
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

// Floats of fp32 scratch of one step (tickets included, as int32 slots).
inline long long trunk_scratch_floats(int S, int D, int H, int T, int attn_chunk) {
  const long long SD = (long long)S * D;
  const long long n_chunks = (T + attn_chunk - 1) / attn_chunk;
  return 9 * SD + 2 * SD / kStatCols                  // x, qkv, ctx, hbuf; statistics
         + SD / kSplitK * 4 * D                        // partial sums of the widest product
         + (long long)S * H * n_chunks * (2 + kHeadDim)  // attention partials
         + 4 * D / kProdCols + (long long)S * H;       // tickets
}

template <typename A, typename C, int kForm, int kMt, int kTiles>
int product_launch(cudaStream_t st, ProductArgs a) {
  using T = Tile<A, kForm>;
  const int n_split = a.K / kSplitK, col_tiles = a.N / kProdCols;
  // the weight and activation tiles; the tail reuses them to stage a row's
  // partial sums of each tile (a warp's quarter with kMaxTiles), so they are
  // at least that large
  const size_t tiles_bytes = (size_t)kTiles * T::kWeightBytes +
                             (sizeof(A) == 2 ? 2 : 1) * (size_t)((a.S + 15) / 16) * 16 *
                                 T::kAld * sizeof(A);
  const size_t tail_bytes = (size_t)kTiles * n_split * kProdCols * sizeof(float);
  const size_t smem = tiles_bytes > tail_bytes ? tiles_bytes : tail_bytes;
  a.stage_floats = static_cast<int>(smem / sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(product_kernel<A, C, kForm, kMt, kTiles>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return launch_pdl(product_kernel<A, C, kForm, kMt, kTiles>,
                    dim3(col_tiles / kTiles, n_split), dim3(kProdThreads), smem, st, a);
}

// One product.  A block takes kMaxTiles column tiles (a warp each) for one
// row where that still leaves at least two blocks for each of the card's
// n_sm SMs, else one tile; tiles change no sum (each column is its own).
// With more rows a warp's four slices were slower than four warps
// (tools/trunk_ab.py, PERF.md).
template <typename A, typename C, int kForm>
int product(cudaStream_t st, const ProductArgs& a, int n_sm) {
  if (a.S > 1) return product_launch<A, C, kForm, 4, 1>(st, a);
  const int col_tiles = a.N / kProdCols, n_split = a.K / kSplitK;
  if (col_tiles % kMaxTiles == 0 && col_tiles / kMaxTiles * n_split >= 2 * n_sm)
    return product_launch<A, C, kForm, 1, kMaxTiles>(st, a);
  return product_launch<A, C, kForm, 1, 1>(st, a);
}

template <typename A, typename C, int kForm>
int trunk_chain(const Params& P, const StepIO& io, int S, int L, int D, int H, int T,
                float* scratch, cudaStream_t st) {
  const long long SD = (long long)S * D;
  float* x = scratch;
  float* qkv = x + SD;
  float* ctx = qkv + 3 * SD;
  float* hbuf = ctx + SD;
  float2* stats = reinterpret_cast<float2*>(hbuf + 4 * SD);
  float* part = hbuf + 4 * SD + 2 * SD / kStatCols;
  float* attn_part = part + SD / kSplitK * 4 * D;
  const long long n_chunks = (T + io.attn_chunk - 1) / io.attn_chunk;
  int* prod_tickets = reinterpret_cast<int*>(attn_part + (long long)S * H * n_chunks *
                                                             (2 + kHeadDim));
  int* attn_tickets = prod_tickets + 4 * D / kProdCols;
  const int n_tickets = 4 * D / kProdCols + S * H;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / H));
  int rc, dev = 0, n_sm = 0;
  if ((rc = static_cast<int>(cudaGetDevice(&dev))) ||
      (rc = static_cast<int>(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev))))
    return rc;

  if ((rc = launch_pdl(trunk_in_kernel<A>, dim3(D / kStatCols, S), dim3(32), 0, st,
                       static_cast<const A*>(io.hidden), x, stats, prod_tickets, n_tickets, D)))
    return rc;
  for (int l = 0; l < L; ++l) {
    auto vec = [&](const void* base, int n) {
      return static_cast<const void*>(static_cast<const A*>(base) + (long long)l * n);
    };
    const Matrix qkv_w = layer_of<A, kForm>(P.qkv, l, D, 3 * D);
    const Matrix proj_w = layer_of<A, kForm>(P.proj, l, D, D);
    const Matrix fc_w = layer_of<A, kForm>(P.fc, l, D, 4 * D);
    const Matrix mproj_w = layer_of<A, kForm>(P.mproj, l, 4 * D, D);
    const C* kl = static_cast<const C*>(io.kc) + l * io.cache_layer;
    const C* vl = static_cast<const C*>(io.vc) + l * io.cache_layer;
    ProductArgs a{};
    a.S = S;
    a.D = D;
    a.part = part;
    a.counters = prod_tickets;
    a.stats_out = stats;

    a.in = x; a.stats_in = stats; a.ln_s = vec(P.ln1_s, D); a.ln_b = vec(P.ln1_b, D);
    a.w = qkv_w.w; a.ws = qkv_w.s; a.groups = qkv_w.groups; a.bias = vec(P.qkv_b, 3 * D);
    a.out = qkv; a.K = D; a.N = 3 * D; a.epi = kStore;
    a.k_new = static_cast<C*>(io.k_new) + l * io.new_layer;
    a.v_new = static_cast<C*>(io.v_new) + l * io.new_layer;
    a.kv_ld = io.new_ld;
    if ((rc = product<A, C, kForm>(st, a, n_sm))) return rc;

    const AttnArgs at{qkv, kl, vl, io.mask, io.positions, io.pos, D, T, io.attn_chunk,
                      scale, attn_part, attn_tickets, ctx};
    if ((rc = launch_pdl(attn_kernel<A, C>, dim3(H, io.attn_chunks, S), dim3(kAttnThreads), 0,
                         st, at)))
      return rc;

    a.k_new = a.v_new = nullptr;
    a.in = ctx; a.stats_in = nullptr; a.w = proj_w.w; a.ws = proj_w.s;
    a.groups = proj_w.groups; a.bias = vec(P.proj_b, D); a.out = x; a.N = D; a.epi = kAddTo;
    if ((rc = product<A, C, kForm>(st, a, n_sm))) return rc;

    a.in = x; a.stats_in = stats; a.ln_s = vec(P.ln2_s, D); a.ln_b = vec(P.ln2_b, D);
    a.w = fc_w.w; a.ws = fc_w.s; a.groups = fc_w.groups; a.bias = vec(P.fc_b, 4 * D);
    a.out = hbuf; a.N = 4 * D; a.epi = kStoreGelu;
    if ((rc = product<A, C, kForm>(st, a, n_sm))) return rc;

    a.in = hbuf; a.stats_in = nullptr; a.w = mproj_w.w; a.ws = mproj_w.s;
    a.groups = mproj_w.groups; a.bias = vec(P.mproj_b, D); a.out = x; a.K = 4 * D; a.N = D;
    a.epi = kAddTo;
    if ((rc = product<A, C, kForm>(st, a, n_sm))) return rc;
  }
  const int n = static_cast<int>(SD);
  return launch_pdl(trunk_out_kernel<A>, dim3((n + 255) / 256), dim3(256), 0, st, x,
                    static_cast<A*>(io.out), n);
}

}  // namespace
