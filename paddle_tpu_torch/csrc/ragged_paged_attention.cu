// Ragged paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/ragged_paged.py::_ragged_kernel
// (launched there by _ragged_attention_kernel).  One launch serves a packed
// token batch that mixes decode rows (one token each) and prefill chunks:
//
//   q            [T, H, D]              packed queries, fp32 or bf16
//   k/v_cache    [NB, bs, Hkv, D]       shared block pools, fp32 or bf16
//   block_tables [R, W]    int32        per-row page tables (pad rows all 0)
//   kv_lens      [R]       int32        KV length of each row after this step
//   seg_ids      [T]       int32        row of each packed token
//   q_pos        [T]       int32        absolute position of each token
//   out          [T, H, D]              q's dtype
//
// Token t attends over its row's pages to the columns
// c < limit_t = min(kv_lens[seg_ids[t]], q_pos[t] + 1); query head h reads
// KV head h / (H / Hkv).  The softmax is the online one of the TPU kernel, in
// fp32, with the same -1e30 mask constant:
//   m_new = max(m, max_c s_c); alpha = exp(m - m_new); p_c = exp(s_c - m_new)
//   l = l * alpha + sum_c p_c;  acc = acc * alpha + sum_c p_c v_c
// and the result acc / max(l, 1e-9) is written in q's dtype.
//
// What bounds it on an H100: the bytes.  A decode row reads its pages once
// per KV head against ~4 flops a K/V element loaded; a prefill chunk of n
// tokens does n times that arithmetic on the same pages, which stays far
// below the card's tensor-core rate at serving lengths.  Two routes, chosen
// from dtype and shape alone (ops/ragged_paged.py::route):
//
// * "tma" (bf16 q and pools, D 64 or 128, bs 8, 16, 32 or 64: the serving
//   path).  Four kernels in one call, none of which reads anything back to
//   the host:
//   - ragged_worklist_kernel builds the work list on the device from
//     seg_ids: each maximal run of consecutive tokens of one row is cut, from
//     its first token, into items of at most per = 128 / rep tokens (rep =
//     H / Hkv), so no item straddles two rows; items of one token go to the
//     decode list, longer ones to the chunk list.
//   - ragged_chunk_kernel: a block per (chunk item, KV head), the item's
//     tokens times the group's rep query heads packed into its 128 rows, as
//     the flash forward packs a GQA group (row r = token r / rep, head
//     r % rep: one TMA box of q).  It walks the row's pages once, 64 keys
//     (64 / bs pages) a tile: each page of K and V comes by two TMA boxes
//     (64, 1, bs, 1) of a 4-d map over the pool (D, Hkv, bs, NB) into a
//     2-stage ring, 128-byte swizzled as hopper.cuh's wgmma descriptors
//     expect, so a K/V tile crosses from device memory once per item (32
//     tokens at rep 4), not once per token.  S = Q.K^T and P.V run on wgmma;
//     only the key tiles past the item's smallest limit are masked.  P.V
//     keeps the TPU kernel's fp32 arithmetic (it multiplies fp32 p by v) by
//     splitting P into a bf16 high part and a bf16 low part, two products;
//     what is left is P's rounding past 16 bits.
//   - ragged_decode_kernel: items of one token have rep rows only, which a
//     64-row wgmma would mostly waste; they are bound by bytes.  The paged
//     decode kernel's algorithm (csrc/paged_decode_attention.cu): lane groups
//     with their own online softmax in registers, 16-byte loads, the KV walk
//     split over blockIdx.z by a count that depends on T, H, Hkv and the SM
//     count only, never on the table width or the data, so a row's output
//     does not depend on its table bucket.
//   - ragged_combine_kernel merges the splits in a fixed order (only when
//     there is more than one).
//   Grids are bounded from T, H, Hkv and the SM count by the caller; blocks
//   loop over the items of their list and exit when it is done.  No atomics:
//   equal inputs give equal outputs.
// * "simple" (fp32, mixed dtypes, other head dims or block sizes): one block
//   per (token, KV head) walks the row's pages with the softmax state in
//   shared memory, staging each page as fp32 (ragged_simple_kernel).  A
//   prefill chunk of n tokens re-reads each page n times; it stays for the
//   shapes the tma route does not take.
//
// Pad tokens point at a pad row whose table is all null pages (block 0) with
// kv_len 1: they read page 0, which holds finite values, so their output is
// finite and is never read by the engine.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ===========================================================================
// The simple route
// ===========================================================================

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory, in floats: q [hpb, D], acc [hpb, D], k [bs, D], v [bs, D],
// p [hpb, bs], m [hpb], l [hpb], alpha [hpb]   (hpb = heads per block).
// At most 149,600 bytes (hpb 8, D 256, bs 64), under the 227 KB a block
// may use; above 48 KB the launch raises the kernel's limit first.
size_t smem_floats(int heads_per_block, int D, int block_size) {
  return 2 * static_cast<size_t>(heads_per_block) * D +
         2 * static_cast<size_t>(block_size) * D +
         static_cast<size_t>(heads_per_block) * block_size + 3 * heads_per_block;
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) ragged_simple_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_cache,
    const KVT* __restrict__ v_cache, const int* __restrict__ block_tables,
    const int* __restrict__ kv_lens, const int* __restrict__ seg_ids,
    const int* __restrict__ q_pos, QT* __restrict__ out, int H, int Hkv, int D,
    int block_size, int W, int heads_per_block, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / Hkv;
  const int r0 = blockIdx.z * heads_per_block;
  const int nh = min(heads_per_block, rep - r0);
  const int h0 = g * rep + r0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;
  float* acc_s = q_s + heads_per_block * D;
  float* k_s = acc_s + heads_per_block * D;
  float* v_s = k_s + block_size * D;
  float* p_s = v_s + block_size * D;
  float* m_s = p_s + heads_per_block * block_size;
  float* l_s = m_s + heads_per_block;
  float* alpha_s = l_s + heads_per_block;

  // the block loads its own routing: no scalar prefetch on this card
  const int seg = seg_ids[t];
  const int limit = min(kv_lens[seg], q_pos[t] + 1);
  int n_pages = limit > 0 ? (limit + block_size - 1) / block_size : 0;
  n_pages = min(n_pages, W);
  const int* table = block_tables + static_cast<long long>(seg) * W;

  // the nh heads h0 .. h0 + nh - 1 of token t are contiguous in q and out
  const long long qo_offset = (static_cast<long long>(t) * H + h0) * D;
  for (int i = tid; i < nh * D; i += kThreads) {
    q_s[i] = to_float(q[qo_offset + i]);
    acc_s[i] = 0.f;
  }
  if (tid < nh) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const long long row_stride = static_cast<long long>(Hkv) * D;
  for (int j = 0; j < n_pages; ++j) {
    const long long page = table[j];
    const long long page_offset = (page * block_size * Hkv + g) * D;
    __syncthreads();  // the previous page is no longer read
    for (int i = tid; i < block_size * D; i += kThreads) {
      const int c = i / D;
      const int d = i - c * D;
      k_s[i] = to_float(k_cache[page_offset + c * row_stride + d]);
      v_s[i] = to_float(v_cache[page_offset + c * row_stride + d]);
    }
    __syncthreads();

    // scores: one warp for each (head, column) pair, lanes split D
    for (int pair = warp; pair < nh * block_size; pair += kWarps) {
      const int r = pair / block_size;
      const int c = pair - r * block_size;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += q_s[r * D + d] * k_s[c * D + d];
      s = warp_sum(s);
      if (lane == 0) p_s[pair] = (j * block_size + c < limit) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online-softmax statistics: one warp for each head
    for (int r = warp; r < nh; r += kWarps) {
      float* p_row = p_s + r * block_size;
      float mx = kNegInf;
      for (int c = lane; c < block_size; c += 32) mx = fmaxf(mx, p_row[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < block_size; c += 32) {
        const float p = expf(p_row[c] - m_new);
        p_row[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, one thread for each (head, d) element
    for (int i = tid; i < nh * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const float* p_row = p_s + r * block_size;
      float pv = 0.f;
      for (int c = 0; c < block_size; ++c) pv += p_row[c] * v_s[c * D + d];
      acc_s[i] = acc_s[i] * alpha_s[r] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < nh * D; i += kThreads) {
    const int r = i / D;
    out[qo_offset + i] = from_float<QT>(acc_s[i] / fmaxf(l_s[r], 1e-9f));
  }
}

template <typename QT, typename KVT>
cudaError_t launch_simple(const void* q, const void* k_cache, const void* v_cache,
                   const void* block_tables, const void* kv_lens,
                   const void* seg_ids, const void* q_pos, void* out, int T,
                   int H, int Hkv, int D, int block_size, int W, float scale,
                   cudaStream_t stream) {
  const int rep = H / Hkv;
  const int heads_per_block = rep < kMaxHeadsPerBlock ? rep : kMaxHeadsPerBlock;
  const size_t smem = sizeof(float) * smem_floats(heads_per_block, D, block_size);
  auto kernel = ragged_simple_kernel<QT, KVT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(T, Hkv, (rep + heads_per_block - 1) / heads_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_cache),
      static_cast<const KVT*>(v_cache), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<const int*>(seg_ids),
      static_cast<const int*>(q_pos), static_cast<QT*>(out), H, Hkv, D,
      block_size, W, heads_per_block, scale);
  return cudaGetLastError();
}


// ===========================================================================
// The tma route: bf16 q and pools
// ===========================================================================

using bf16 = __nv_bfloat16;

// The work list, int32: [0] chunk items, [1] decode items, then four
// arrays of T: the chunk items' first tokens, their token counts, the decode
// items' tokens, and the item starts of the list's first pass.
constexpr int kListHead = 2;
constexpr int kListThreads = 1024;

// An inclusive scan (a sum, or a max with kMax) over a block of
// kListThreads threads; `total` is the scan of the whole block.  `sm` holds
// 32 ints and is free again on return.
template <bool kMax>
__device__ __forceinline__ int block_scan(int v, int* sm, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = kMax ? max(v, n) : v + n;
  }
  if (lane == 31) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = sm[lane];   // kListThreads / 32 = 32 warp totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = kMax ? max(w, n) : w + n;
    }
    sm[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = kMax ? max(v, sm[warp - 1]) : v + sm[warp - 1];
  total = sm[31];
  __syncthreads();
  return v;
}

// One block.  First pass: a token starts an item when it opens a run of its
// row (t == 0 or seg_ids[t] != seg_ids[t - 1]) or lies a multiple of `per`
// tokens past the run's first token; the starts are written in token order.
// Second pass: an item ends where the next one starts, and goes to the
// chunk list (more than one token) or to the decode list (one token), each
// in token order.
__global__ void __launch_bounds__(kListThreads)
    ragged_worklist_kernel(const int* __restrict__ seg_ids, int T, int per,
                           int* __restrict__ work) {
  __shared__ int sm[32];
  int* chunk_t0 = work + kListHead;
  int* chunk_n = chunk_t0 + T;
  int* decode_t = chunk_n + T;
  int* starts = decode_t + T;
  int run = 0;     // the first token of the run open at the tile's start
  int items = 0;
  for (int base = 0; base < T; base += kListThreads) {
    const int t = base + threadIdx.x;
    const bool valid = t < T;
    const bool opens = valid && (t == 0 || seg_ids[t] != seg_ids[t - 1]);
    int total;
    const int first = max(block_scan<true>(opens ? t : -1, sm, total), run);
    run = max(run, total);
    const int starts_item = valid && (t - first) % per == 0;
    const int idx = block_scan<false>(starts_item, sm, total) - starts_item;
    if (starts_item) starts[items + idx] = t;
    items += total;
  }
  __syncthreads();   // every start is written
  int n_chunk = 0, n_decode = 0;
  for (int base = 0; base < items; base += kListThreads) {
    const int i = base + threadIdx.x;
    const int t0 = i < items ? starts[i] : 0;
    const int n = i < items ? (i + 1 < items ? starts[i + 1] : T) - t0 : 0;
    const int chunk = n > 1;
    const int single = n == 1;
    int tc, td;
    const int ic = block_scan<false>(chunk, sm, tc) - chunk;
    const int id = block_scan<false>(single, sm, td) - single;
    if (chunk) {
      chunk_t0[n_chunk + ic] = t0;
      chunk_n[n_chunk + ic] = n;
    }
    if (single) decode_t[n_decode + id] = t0;
    n_chunk += tc;
    n_decode += td;
  }
  if (threadIdx.x == 0) {
    work[0] = n_chunk;
    work[1] = n_decode;
  }
}

// --- chunk items on wgmma ------------------------------------------------------

constexpr int kChunkThreads = 256;   // two consumer warpgroups
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kRows = 128;           // rows of a chunk block
constexpr int kKeys = 64;            // keys of a K/V tile
constexpr int kStages = 2;           // ring depth
constexpr int kBox = 64;             // bf16 columns of a TMA box
constexpr int kMaxTilePages = kKeys / 8;   // pages of a tile at bs = 8

// Grid (chunk_blocks, Hkv), kChunkThreads threads.  The block serves KV
// head blockIdx.y of chunk items blockIdx.x, blockIdx.x + gridDim.x, ...
// Consumer thread 0 issues every TMA load and refills a stage once all 8
// warps have released it (the flash dQ and dK/dV kernels' scheme: no
// producer warp, which would cap every thread's registers).
template <int D>
__global__ void __launch_bounds__(kChunkThreads, 1)
    ragged_chunk_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ seg_ids,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ work, bf16* __restrict__ out,
                        int T, int H, int Hkv, int bs, int W, int per,
                        float scale_log2) {
  using namespace hopper;
  constexpr int kBoxes = D / kBox;
  constexpr int kQBox = kRows * 128;   // bytes of one box of the Q tile
  constexpr int kKBox = kKeys * 128;   // ... of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + kBoxes * kQBox;               // [stage][box]
  unsigned char* Vs = Ks + kStages * kBoxes * kKBox;     // [stage][box]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * kBoxes * kKBox);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  __shared__ int item_limits[2];   // the item's smallest and largest limit

  const int n_items = work[0];
  if (static_cast<int>(blockIdx.x) >= n_items) return;
  const int* starts = work + kListHead;
  const int* counts = starts + T;
  const int rep = H / Hkv;
  const int rows = per * rep;
  const int g = blockIdx.y;
  const int tile_pages = kKeys / bs;

  // Rows past `rows` and the key slots past a row's last page are never
  // loaded: zeros keep them finite (a masked key still multiplies its V
  // row by 0); later items leave earlier pages' finite values there.
  for (int i = threadIdx.x; i < (kBoxes * kQBox + 2 * kStages * kBoxes * kKBox) / 16;
       i += kChunkThreads)
    reinterpret_cast<uint4*>(Qs)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kChunkWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t & 31;
  const int c = lane & 3;
  int done = 0;        // tiles this block has consumed, over its items
  uint32_t q_phase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int t0 = starts[item];
    const int n = counts[item];
    const int seg = seg_ids[t0];
    const int kvl = min(kv_lens[seg], W * bs);
    if (threadIdx.x < 32) {
      int lo = 0x7fffffff, hi = 0;
      for (int k = threadIdx.x; k < n; k += 32) {
        const int lim = min(kvl, q_pos[t0 + k] + 1);
        lo = min(lo, lim);
        hi = max(hi, lim);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (threadIdx.x == 0) {
        item_limits[0] = lo;
        item_limits[1] = max(hi, 0);
      }
    }
    __syncthreads();   // also: every warp is done with the last item's tiles
    const int lo = item_limits[0];
    const int hi = item_limits[1];
    const int n_tiles = (hi + kKeys - 1) / kKeys;
    const int n_pages = (hi + bs - 1) / bs;
    const int* table = block_tables + static_cast<long long>(seg) * W;

    // thread 0: the pages of tile j, read ahead of the loads that use them
    int pages[kMaxTilePages];
    auto fetch = [&](int j) {
#pragma unroll
      for (int p = 0; p < kMaxTilePages; ++p) {
        const int at = j * tile_pages + p;
        pages[p] = p < tile_pages && at < n_pages ? table[at] : -1;
      }
    };
    // tile j of this item into stage (done + j) % kStages
    auto issue = [&](int j) {
      const int st = (done + j) % kStages;
      const int np = min(tile_pages, n_pages - j * tile_pages);
      mbar_arrive_expect(full + st, 2 * np * bs * D * 2);
#pragma unroll
      for (int p = 0; p < kMaxTilePages; ++p) {
        if (pages[p] < 0) continue;
        for (int x = 0; x < kBoxes; ++x) {
          const int off = (st * kBoxes + x) * kKBox + p * bs * 128;
          tma_load_4d(Ks + off, &tk, full + st, x * kBox, g, 0, pages[p]);
          tma_load_4d(Vs + off, &tv, full + st, x * kBox, g, 0, pages[p]);
        }
      }
    };
    if (threadIdx.x == 0) {
      mbar_arrive_expect(q_full, kBoxes * rows * 128);
      for (int x = 0; x < kBoxes; ++x)
        tma_load_4d(Qs + x * kQBox, &tq, q_full, x * kBox, g * rep, t0, 0);
      for (int j = 0; j < min(kStages, n_tiles); ++j) {
        fetch(j);
        issue(j);
      }
    }
    __syncwarp();

    // this thread's two rows: row r is token t0 + r / rep, head r % rep
    int tok[2], head[2], lim[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = cw * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * i;
      const int k = min(r / rep, n - 1);
      live[i] = r < rows && r / rep < n;
      tok[i] = t0 + k;
      head[i] = g * rep + r % rep;
      lim[i] = min(kvl, q_pos[tok[i]] + 1);
    }
    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};   // this thread's part of each row's sum

    mbar_wait(q_full, q_phase);
    q_phase ^= 1;
    for (int j = 0; j < n_tiles; ++j) {
      const int it = done + j;
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      if (threadIdx.x == 0 && j + kStages < n_tiles) fetch(j + kStages);
      const int k0 = j * kKeys;
      float s[kKeys / 2];
      const uint32_t qa = smem_addr(Qs) + cw * 64 * 128;
      const uint32_t ka = smem_addr(Ks) + st * kBoxes * kKBox;
      const uint32_t va = smem_addr(Vs) + st * kBoxes * kKBox;
      mbar_wait(full + st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, kmajor(qa + (kk / 4) * kQBox + (kk % 4) * 32),
                     kmajor(ka + (kk / 4) * kKBox + (kk % 4) * 32), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scores in the exp2 domain; keys at or past a row's limit get -1e30
      const bool edge = k0 + kKeys > lo;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * jj + 2 * i + e];
            x *= scale_log2;
            if (edge && k0 + 8 * jj + 2 * c + e >= lim[i]) x = kNegInf;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[i], quad_max(mx));
        const float corr = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * jj + 2 * i + e];
            x = ex2(x - m_new);
            sum += x;
          }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn) {
          o[4 * nn + 2 * i] *= corr;
          o[4 * nn + 2 * i + 1] *= corr;
        }
      }
      // P = high + low, each rounded to bf16: the two products keep P.V at
      // the TPU kernel's fp32 p to 16 bits
      uint32_t p_hi[kKeys / 16][4], p_lo[kKeys / 16][4];
      to_a_frags<kKeys / 16>(p_hi, s);
#pragma unroll
      for (int x = 0; x < kKeys / 2; x += 2) {
        const float2 h = __bfloat1622float2(
            __floats2bfloat162_rn(s[x], s[x + 1]));
        s[x] -= h.x;
        s[x + 1] -= h.y;
      }
      to_a_frags<kKeys / 16>(p_lo, s);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs<D>(o, p_hi[kk], mnmajor(va + kk * 16 * 128, kKBox));
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs<D>(o, p_lo[kk], mnmajor(va + kk * 16 * 128, kKBox));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + st);
      // refill this stage with tile j + kStages once every warp is done
      if (threadIdx.x == 0 && j + kStages < n_tiles) {
        mbar_wait(empty + st, ph);
        issue(j + kStages);
      }
      __syncwarp();   // the wgmmas ahead need the whole warp
    }
    done += n_tiles;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = fmaxf(quad_sum(l[i]), 1e-9f);
      if (!live[i]) continue;
      bf16* orow = out + (static_cast<long long>(tok[i]) * H + head[i]) * D +
                   2 * c;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
        *reinterpret_cast<uint32_t*>(orow + 8 * nn) =
            pack_bf16(o[4 * nn + 2 * i] / sum, o[4 * nn + 2 * i + 1] / sum);
    }
  }
}

// --- decode items: the paged decode kernel's lane groups ----------------------

constexpr int kDecThreads = 128;
constexpr int kTok = 4;        // tokens a lane group loads per step
constexpr int kGroup = 16;     // lanes reading one token row (16 x 8 bf16)
constexpr int kVec = 8;        // bf16 values of one 16-byte load
constexpr int kMaxD = 128;

// The 8 bf16 values of one 16-byte load, as fp32 (bf16 is the high half of
// an fp32; element 2i is the low half of word i).
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Grid (decode_blocks, Hkv * head_chunks, splits), kDecThreads threads.  The
// block serves decode items blockIdx.x, blockIdx.x + gridDim.x, ...: for
// each, the query heads h0 .. h0 + nh - 1 (nh <= HPB) of KV head g and the
// columns [c0, c1) of split blockIdx.z.  A lane reads one 16-byte chunk of a
// token row (D <= 128).
template <int HPB>
__global__ void __launch_bounds__(kDecThreads) ragged_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
    const bf16* __restrict__ v_cache, const int* __restrict__ block_tables,
    const int* __restrict__ kv_lens, const int* __restrict__ seg_ids,
    const int* __restrict__ q_pos, const int* __restrict__ work,
    bf16* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int T, int H, int Hkv, int D, int bs,
    int W, float scale) {
  constexpr int G = kGroup;
  constexpr int VEC = kVec;
  constexpr int GPW = 32 / G;             // lane groups per warp
  constexpr int NG = kDecThreads / G;     // lane groups per block
  __shared__ float acc_s[NG * HPB * kMaxD];
  __shared__ float m_s[NG * HPB];
  __shared__ float l_s[NG * HPB];

  const int n_dec = work[1];
  const int* tokens = work + kListHead + 2 * T;
  const int rep = H / Hkv;
  const int head_chunks = (rep + HPB - 1) / HPB;
  const int g = blockIdx.y / head_chunks;
  const int r0 = (blockIdx.y - g * head_chunks) * HPB;
  const int nh = min(HPB, rep - r0);
  const int h0 = g * rep + r0;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gw = (tid & 31) / G;
  const int grp = warp * GPW + gw;
  const int lane = tid & (G - 1);
  const int n_chunks = D / VEC;
  const bool lane_live = lane < n_chunks;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int item = blockIdx.x; item < n_dec; item += gridDim.x) {
    const int tq = tokens[item];
    const int seg = seg_ids[tq];
    const int len =
        max(min(min(kv_lens[seg], q_pos[tq] + 1), W * bs), 0);
    const int per = (len + nsplit - 1) / nsplit;
    const int c0 = min(len, static_cast<int>(blockIdx.z) * per);
    const int c1 = min(len, c0 + per);
    const int* table = block_tables + static_cast<long long>(seg) * W;

    // this lane's slice of each query head, pre-scaled
    float qr[HPB][VEC];
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      const bool live = h < nh && lane_live;
      const uint4 u = live ? *reinterpret_cast<const uint4*>(
                                 q + (static_cast<long long>(tq) * H + h0 + h) * D +
                                 lane * VEC)
                           : zero;
      unpack8(u, qr[h]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[h][e] *= scale;
    }

    float acc[HPB][VEC];
    float m[HPB], l[HPB];
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[h][e] = 0.f;
    }

    // The loop bound is uniform across a warp (the shuffles below need
    // every lane); tokens at or past c1 are loaded by nobody and weigh
    // nothing.
    for (int wbase = c0 + warp * GPW * kTok; wbase < c1;
         wbase += NG * kTok) {
      const int base = wbase + gw * kTok;
      uint4 kr[kTok], vr[kTok];
#pragma unroll
      for (int tt = 0; tt < kTok; ++tt) {
        const int col = base + tt;
        const bool live = col < c1;
        const long long page = live ? table[col / bs] : 0;
        const long long at =
            ((page * bs + (live ? col % bs : 0)) * Hkv + g) * D + lane * VEC;
        const bool load = live && lane_live;
        kr[tt] = load ? *reinterpret_cast<const uint4*>(k_cache + at) : zero;
        vr[tt] = load ? *reinterpret_cast<const uint4*>(v_cache + at) : zero;
      }

      // scores: lane-partial dot products, summed over the lane group
      float s[kTok][HPB];
#pragma unroll
      for (int tt = 0; tt < kTok; ++tt) {
        float kf[VEC];
        unpack8(kr[tt], kf);
#pragma unroll
        for (int h = 0; h < HPB; ++h) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) x += qr[h][e] * kf[e];
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          s[tt][h] = x;
        }
      }

      // online softmax over this group's tokens
      float p[kTok][HPB];
#pragma unroll
      for (int h = 0; h < HPB; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int tt = 0; tt < kTok; ++tt)
          if (base + tt < c1) mx = fmaxf(mx, s[tt][h]);
        const float m_new = fmaxf(m[h], mx);
        const float alpha = expf(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int tt = 0; tt < kTok; ++tt) {
          p[tt][h] = base + tt < c1 ? expf(s[tt][h] - m_new) : 0.f;
          sum += p[tt][h];
        }
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] *= alpha;
      }
#pragma unroll
      for (int tt = 0; tt < kTok; ++tt) {
        float vf[VEC];
        unpack8(vr[tt], vf);
#pragma unroll
        for (int h = 0; h < HPB; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[h][e] += p[tt][h] * vf[e];
      }
    }

    // merge the lane groups, in group order
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      if (lane == 0) {
        m_s[grp * HPB + h] = m[h];
        l_s[grp * HPB + h] = l[h];
      }
      if (lane_live) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc_s[(grp * HPB + h) * D + lane * VEC + e] = acc[h][e];
      }
    }
    __syncthreads();
    for (int i = tid; i < nh * D; i += kDecThreads) {
      const int h = i / D;
      const int d = i - h * D;
      float M = kNegInf;
      for (int gi = 0; gi < NG; ++gi) M = fmaxf(M, m_s[gi * HPB + h]);
      float L = 0.f, A = 0.f;
      for (int gi = 0; gi < NG; ++gi) {
        const float w = expf(m_s[gi * HPB + h] - M);
        L += l_s[gi * HPB + h] * w;
        A += acc_s[(gi * HPB + h) * D + d] * w;
      }
      if (nsplit == 1) {
        out[(static_cast<long long>(tq) * H + h0 + h) * D + d] =
            __float2bfloat16(A / fmaxf(L, 1e-9f));
      } else {
        const long long slot =
            (static_cast<long long>(item) * H + h0 + h) * nsplit + blockIdx.z;
        part_acc[slot * D + d] = A;
        if (d == 0) {
          part_ml[2 * slot] = M;
          part_ml[2 * slot + 1] = L;
        }
      }
    }
    __syncthreads();   // the next item reuses the shared arrays
  }
}

// Grid (decode_blocks, H), kDecThreads threads: merges the splits of one
// (decode item, head), in split order.
__global__ void __launch_bounds__(kDecThreads) ragged_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ work, bf16* __restrict__ out, int T, int H, int D,
    int nsplit) {
  const int n_dec = work[1];
  const int* tokens = work + kListHead + 2 * T;
  const int h = blockIdx.y;
  for (int item = blockIdx.x; item < n_dec; item += gridDim.x) {
    const long long slot = static_cast<long long>(item) * H + h;
    const float* ml = part_ml + 2 * slot * nsplit;
    float M = kNegInf;
    for (int z = 0; z < nsplit; ++z) M = fmaxf(M, ml[2 * z]);
    float L = 0.f;
    for (int z = 0; z < nsplit; ++z) L += ml[2 * z + 1] * expf(ml[2 * z] - M);
    bf16* o = out + (static_cast<long long>(tokens[item]) * H + h) * D;
    for (int d = threadIdx.x; d < D; d += kDecThreads) {
      float A = 0.f;
      for (int z = 0; z < nsplit; ++z)
        A += part_acc[(slot * nsplit + z) * D + d] * expf(ml[2 * z] - M);
      o[d] = __float2bfloat16(A / fmaxf(L, 1e-9f));
    }
  }
}

// Dynamic shared memory of the chunk kernel: 1024 bytes of slack to align
// the tiles, the Q tile, the K and V stages and the mbarriers.
constexpr int chunk_bytes(int D) {
  return 1024 + (kRows + 2 * kStages * kKeys) * D * 2 + (1 + 2 * kStages) * 8;
}

template <int D>
cudaError_t launch_chunks(const void* q, const void* k_cache,
                          const void* v_cache, const void* block_tables,
                          const void* kv_lens, const void* seg_ids,
                          const void* q_pos, const int* work, void* out, int T,
                          int H, int Hkv, int bs, int W, int num_blocks,
                          int per, int blocks, float scale,
                          cudaStream_t stream) {
  const int rep = H / Hkv;
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;   // bytes of a row
  CUtensorMap tq, tk, tv;
  // q [T, H, D] as (D, H, T, 1), boxes of the group's rep heads at per
  // tokens; the pools [NB, bs, Hkv, D] as (D, Hkv, bs, NB), a box per page
  const cuuint64_t q_dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(T), 1};
  const cuuint64_t q_strides[3] = {row, row * H, row * H * T};
  const cuuint32_t q_box[4] = {kBox, static_cast<cuuint32_t>(rep),
                               static_cast<cuuint32_t>(per), 1};
  const cuuint64_t kv_dims[4] = {static_cast<cuuint64_t>(D),
                                 static_cast<cuuint64_t>(Hkv),
                                 static_cast<cuuint64_t>(bs),
                                 static_cast<cuuint64_t>(num_blocks)};
  const cuuint64_t kv_strides[3] = {row, row * Hkv, row * Hkv * bs};
  const cuuint32_t kv_box[4] = {kBox, 1, static_cast<cuuint32_t>(bs), 1};
  cudaError_t err;
  if ((err = hopper::bf16_map_4d(&tq, q, q_dims, q_strides, q_box)) !=
          cudaSuccess ||
      (err = hopper::bf16_map_4d(&tk, k_cache, kv_dims, kv_strides,
                                 kv_box)) != cudaSuccess ||
      (err = hopper::bf16_map_4d(&tv, v_cache, kv_dims, kv_strides,
                                 kv_box)) != cudaSuccess)
    return err;
  const int bytes = chunk_bytes(D);
  auto kernel = ragged_chunk_kernel<D>;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
      cudaSuccess)
    return err;
  kernel<<<dim3(blocks, Hkv), kChunkThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<const int*>(seg_ids),
      static_cast<const int*>(q_pos), work, static_cast<bf16*>(out), T, H,
      Hkv, bs, W, per, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HPB>
cudaError_t launch_decodes(const void* q, const void* k_cache,
                           const void* v_cache, const void* block_tables,
                           const void* kv_lens, const void* seg_ids,
                           const void* q_pos, const int* work, void* out,
                           void* part_acc, void* part_ml, int T, int H,
                           int Hkv, int D, int bs, int W, int nsplit,
                           int blocks, float scale, cudaStream_t stream) {
  const int head_chunks = (H / Hkv + HPB - 1) / HPB;
  ragged_decode_kernel<HPB>
      <<<dim3(blocks, Hkv * head_chunks, nsplit), kDecThreads, 0, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k_cache),
          static_cast<const bf16*>(v_cache),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(kv_lens), static_cast<const int*>(seg_ids),
          static_cast<const int*>(q_pos), work, static_cast<bf16*>(out),
          static_cast<float*>(part_acc), static_cast<float*>(part_ml), T, H,
          Hkv, D, bs, W, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  ragged_combine_kernel<<<dim3(blocks, H), kDecThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      work, static_cast<bf16*>(out), T, H, D, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The simple route.  Launches on `stream` and returns cudaGetLastError() (0
// on success).  The caller has checked shapes, types, devices and
// contiguity; T >= 1.  q_bf16 / kv_bf16: 0 for fp32, 1 for bf16.
int ragged_paged_attention_launch(const void* q, const void* k_cache,
                                  const void* v_cache, const void* block_tables,
                                  const void* kv_lens, const void* seg_ids,
                                  const void* q_pos, void* out, int T, int H,
                                  int Hkv, int D, int block_size, int W,
                                  int q_bf16, int kv_bf16, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16) {
    err = launch_simple<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, v_cache, block_tables, kv_lens, seg_ids, q_pos, out, T, H,
        Hkv, D, block_size, W, scale, s);
  } else if (q_bf16) {
    err = launch_simple<__nv_bfloat16, float>(
        q, k_cache, v_cache, block_tables, kv_lens, seg_ids, q_pos, out, T, H,
        Hkv, D, block_size, W, scale, s);
  } else if (kv_bf16) {
    err = launch_simple<float, __nv_bfloat16>(
        q, k_cache, v_cache, block_tables, kv_lens, seg_ids, q_pos, out, T, H,
        Hkv, D, block_size, W, scale, s);
  } else {
    err = launch_simple<float, float>(q, k_cache, v_cache, block_tables,
                                      kv_lens, seg_ids, q_pos, out, T, H, Hkv,
                                      D, block_size, W, scale, s);
  }
  return static_cast<int>(err);
}

// The work list alone (the first kernel of the tma route), into `work`
// (2 + 4 T int32): for checking it against its plain twin.
int ragged_worklist_launch(const void* seg_ids, int T, int per, void* work,
                           void* stream) {
  if (T < 1 || per < 1) return static_cast<int>(cudaErrorInvalidValue);
  ragged_worklist_kernel<<<1, kListThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg_ids), T, per, static_cast<int*>(work));
  return static_cast<int>(cudaGetLastError());
}

// The tma route: bf16 q and pools, D 64 or 128, block_size 8, 16, 32 or 64,
// 16-byte-aligned contiguous inputs (checked by the caller).  Scratch from
// the caller: `work` (2 + 4 T int32) and, when nsplit > 1, part_acc
// (T * H * nsplit * D floats) and part_ml (T * H * nsplit * 2).  `per`
// (tokens of a chunk item, 1 <= per <= 128 / (H / Hkv)), nsplit and the
// two grids' widths depend on T, H, Hkv and the SM count only.
int ragged_paged_attention_tma_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* kv_lens, const void* seg_ids,
    const void* q_pos, void* out, void* work, void* part_acc, void* part_ml,
    int T, int H, int Hkv, int D, int block_size, int W, int num_blocks,
    int per, int nsplit, int chunk_blocks, int decode_blocks, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = H / Hkv;
  if ((D != 64 && D != 128) || block_size < 8 || block_size > 64 ||
      kKeys % block_size || T < 1 || per < 1 || per * rep > kRows ||
      nsplit < 1 || chunk_blocks < 1 || decode_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = static_cast<cudaError_t>(
      ragged_worklist_launch(seg_ids, T, per, work, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* list = static_cast<const int*>(work);
  if (per > 1) {
    err = D == 64
              ? launch_chunks<64>(q, k_cache, v_cache, block_tables, kv_lens,
                                  seg_ids, q_pos, list, out, T, H, Hkv,
                                  block_size, W, num_blocks, per,
                                  chunk_blocks, scale, s)
              : launch_chunks<128>(q, k_cache, v_cache, block_tables,
                                   kv_lens, seg_ids, q_pos, list, out, T, H,
                                   Hkv, block_size, W, num_blocks, per,
                                   chunk_blocks, scale, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#define RPA_DECODE(P)                                                        \
  launch_decodes<P>(q, k_cache, v_cache, block_tables, kv_lens, seg_ids,    \
                    q_pos, list, out, part_acc, part_ml, T, H, Hkv, D,      \
                    block_size, W, nsplit, decode_blocks, scale, s)
  err = rep == 1 ? RPA_DECODE(1) : rep == 2 ? RPA_DECODE(2) : RPA_DECODE(4);
#undef RPA_DECODE
  return static_cast<int>(err);
}

const char* ragged_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
