// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_paged.py::_decode_kernel
// (launched there by paged_attention_decode).  One new token per row attends
// over that row's pages of the shared KV pools:
//
//   q            [B, H, D]              one query token per row, fp32 or bf16
//   k/v_cache    [NB, bs, Hkv, D]       shared block pools, fp32 or bf16
//   block_tables [B, W]    int32        per-row page tables (0-padded)
//   seq_lens     [B]       int32        KV length of each row (this token's
//                                       K/V already written)
//   out          [B, H, D]              q's dtype
//
// Row b, query head h attends to the columns c < min(seq_lens[b], W * bs) of
// K/V head h / (H / Hkv): softmax_c(scale * q[b,h] . K[c]) . V, with
// K[c] = k_cache[block_tables[b, c / bs], c % bs, h / (H / Hkv)].
// Everything is accumulated in fp32 (the -1e30 mask, the max(l, 1e-9)
// guard; the exponentials in base 2 on scores pre-scaled by log2 e) and
// written in q's dtype.  Pages at or past ceil(seq_lens[b] / bs) are never
// read, so a table padded far past a row's length (the decode-burst tables
// are) costs nothing.  A pad row (len 1, all-null table) reads page 0,
// which holds finite values.  A row with seq_lens == 0 reads nothing and
// gets zeros (the TPU kernel gives zeros too: acc 0 over max(l, 1e-9)); the
// engine never builds one.
//
// What bounds it on an H100: the bytes.  Each row's live K and V pages are
// read once per KV head (the query heads of a GQA group share the read),
// against ~4 flops a K/V element: q, out and the live pages over 3.35 TB/s
// is the floor.  What the design does about it:
//   * Length-balanced work.  A row's walk is cut into spans of `span`
//     tokens, a multiple of the page size fixed by the caller from the page
//     size alone (ops/paged_decode.py::span_tokens), so a work item is one
//     (row, KV head group, span) and items carry near-equal bytes: the
//     launch does not end on one long row.  The grid is bounded from the SM
//     count and the occupancy; each block loops over the items, which it
//     finds from seq_lens itself (a warp scans the rows' span counts), so
//     nothing is read back to the host.
//   * Loads that overlap: a span's K and V rows come into shared memory by
//     16-byte cp.async copies (zero-filled, not read, past the row's length)
//     in stages of 16 tokens (8 for fp32 pools on the simple route), several
//     in flight while the first is used.  Blocks stay small (128 threads,
//     3 resident an SM on the mma route) so that the loads of some blocks
//     overlap the arithmetic and merges of others.
//   * Few instructions per byte.  Two routes (ops/paged_decode.py::route):
//     - "mma" (bf16 q and pools, D 64 or 128, pages that divide 128 tokens:
//       the serving path).  A block holds a whole 128-token span (and Q) in
//       shared memory, swizzled for ldmatrix: its 8 stages are all issued
//       at once, each warp copying and then computing its own two, so a
//       warp waits on its own copies only.  Up to 16 query
//       heads of a GQA group are the 16 rows of mma.sync m16n8k16 products
//       (S = Q.K^T with K read by ldmatrix, P.V with V read by ldmatrix
//       .trans), so the group shares each K/V row and a token costs a few
//       warp instructions.  P.V keeps the TPU kernel's fp32 p by splitting
//       P into bf16 high and low parts, two products.
//     - "simple" (every other pairing and shape): a group of lanes takes one
//       token row with 16-byte reads from a 4-stage ring (16 lanes for bf16
//       at D = 128, a warp for fp32) and keeps its own online softmax (max,
//       sum, fp32 accumulator in registers) for up to 4 heads.
//     The parts of a block (warps or lane groups) are merged in part order.
//   * The merge of a row's spans.  A row of one span writes its output
//     directly.  Otherwise each span's block writes its (max, sum, acc)
//     partial, and a second, small kernel (paged_decode_combine_kernel, one
//     block per (row, head group)) merges spans 0, 1, 2, ... in that order,
//     with an online rescale, a row's loads in one round.  It keeps no
//     state between launches.  A row's output thus depends on its own
//     length and data only, never on B, W or the other rows, and equal
//     inputs give equal bits, run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;      // simple route's ring: 3 stages in flight
constexpr int kTokPerGroup = 2; // tokens a lane group takes from a stage
constexpr int kMaxD = 256;
constexpr int kMaxSpanPages = 128;
constexpr int kMmaSpan = 128;   // mma route: tokens of a span at most
constexpr int kMmaRows = 16;    // mma route: query heads of a block
constexpr int kChunk = 16;      // spans the combine loads at once
constexpr int kWaves = 2;       // walk blocks a grid holds per resident one
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// A lane group reads one token row of D elements with 16-byte loads: kVec
// elements a load, kGroup lanes a group (bf16 D <= 256 and fp32 D <= 256
// need at most 2 loads per lane per row).
template <typename T>
struct Layout;
template <>
struct Layout<float> {
  static constexpr int kVec = 4;
  static constexpr int kGroup = 32;
};
template <>
struct Layout<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kGroup = 16;
};

// Tokens of one ring stage: every lane group takes kTokPerGroup of them.
template <typename KVT>
__host__ __device__ constexpr int stage_tokens() {
  return kThreads / Layout<KVT>::kGroup * kTokPerGroup;
}

// Bytes of dynamic shared memory of the simple route: the ring of K and V
// stages.  The merge of the lane groups reuses it (NG * HPB * D floats, at
// most half of it).
template <typename KVT>
int ring_bytes(int D) {
  return kStages * 2 * stage_tokens<KVT>() * D * static_cast<int>(sizeof(KVT));
}

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The kVec values of one 16-byte load, as fp32.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  // bf16 is the high half of an fp32; element 2i is the low half of word i
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously; with
// live false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), plain or transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// d += A . B, m16n8k16, bf16 in, fp32 accumulate.  Thread (g = lane / 4,
// t = lane % 4) holds A rows g and g + 8 at columns 2t, 2t + 1 (a0, a1) and
// 2t + 8, 2t + 9 (a2, a3); B column g at rows 2t, 2t + 1 (b0) and 2t + 8,
// 2t + 9 (b1); d rows g (d0, d1) and g + 8 (d2, d3) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values rounded to bf16 in one register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Query heads a simple-route block holds (HPB): wider groups take several
// blocks.
__host__ __device__ __forceinline__ int heads_per_block(int rep) {
  return rep == 1 ? 1 : rep == 2 ? 2 : 4;
}

// One work item: (row-span rs, head group gi) with row-spans numbered row
// by row, spans in order.
struct Item {
  int row, span, spans, len, total;
};

// Warp 0's part of finding item `it`: an inclusive scan of the rows' span
// counts, 32 rows at a time, into *item (total: the row-spans of all rows).
__device__ __forceinline__ void locate_item(Item* item,
                                            const int* __restrict__ seq_lens,
                                            int B, int len_cap, int span,
                                            int rs, int lane) {
  int carry = 0;
  for (int base = 0; base < B; base += 32) {
    const int b = base + lane;
    int len = 0, n = 0;
    if (b < B) {
      len = min(max(seq_lens[b], 0), len_cap);
      n = max(1, (len + span - 1) / span);   // an empty row has one span
    }
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int first = carry + incl - n;
    if (b < B && rs >= first && rs < first + n) {
      item->row = b;
      item->span = rs - first;
      item->spans = n;
      item->len = len;
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) item->total = carry;
}

// Floats of one item's span partial: for each of its prow heads acc[D],
// then each head's max, then each head's sum, padded to a multiple of 4 so
// that every partial's accumulators start on 16 bytes.
__host__ __device__ __forceinline__ int partial_floats(int prow, int D) {
  return (prow * (D + 2) + 3) / 4 * 4;
}

// The end of an item, by the whole block (every thread calls it).  The
// block's parts (lane groups or warps) left online-softmax states in shared
// memory, in the log2 domain: m_s[p * rows + h], l_s[p * rows + h] and
// acc_s[(p * rows + h) * D + d] for parts p < nparts and heads h < nh.
// They are merged in part order.  A row of one span writes its output;
// otherwise the item's partial goes to `part` (partial_floats(prow, D)
// floats an item), for paged_decode_combine_kernel.
template <typename QT>
__device__ __forceinline__ void finish_item(
    const float* acc_s, const float* m_s, const float* l_s, int nparts,
    int rows, QT* __restrict__ out, float* __restrict__ part,
    const Item& item, int H, int h0, int nh, int D, int gi, int groups,
    int maxspans, int prow) {
  float* at = part + ((static_cast<long long>(item.row) * groups + gi) *
                          maxspans + item.span) * partial_floats(prow, D);
  QT* out_row = out + (static_cast<long long>(item.row) * H + h0) * D;
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int h = i / D;
    float M = kNegInf;
    for (int p = 0; p < nparts; ++p) M = fmaxf(M, m_s[p * rows + h]);
    float L = 0.f, A = 0.f;
    for (int p = 0; p < nparts; ++p) {
      const float w = ex2(m_s[p * rows + h] - M);
      L += l_s[p * rows + h] * w;
      A += acc_s[(p * rows + h) * D + i - h * D] * w;
    }
    if (item.spans == 1) {
      out_row[i] = from_float<QT>(A / fmaxf(L, 1e-9f));
    } else {
      at[i] = A;
      if (i - h * D == 0) {
        at[prow * D + h] = M;
        at[prow * D + prow + h] = L;
      }
    }
  }
}

// Grid (B * G), kThreads threads: merges the span partials of one (row,
// head group) in span order, 0, 1, 2, ..., into its output (rows of one
// span were written by the walk).  hpb: the query heads of a head group
// (G = Hkv * ceil(rep / hpb)); prow = min(rep, hpb).  For each span j in
// order, with M the running max: M' = max(M, m_j), a = 2^(M - M'),
// w = 2^(m_j - M'), L = L a + l_j w, A = A a + acc_j w; out = A / max(L,
// 1e-9).  A thread takes 4 neighbouring outputs of one head and issues the
// loads of kChunk spans (their max, sum and 16 bytes of acc) at once, so
// a row of up to kChunk spans costs one round of loads.
template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ seq_lens,
    QT* __restrict__ out, int H, int Hkv, int D, int len_cap, int span,
    int maxspans, int hpb) {
  const int rep = H / Hkv;
  const int head_chunks = (rep + hpb - 1) / hpb;
  const int groups = Hkv * head_chunks;
  const int b = blockIdx.x / groups;
  const int gi = blockIdx.x - b * groups;
  const int len = min(max(seq_lens[b], 0), len_cap);
  const int spans = max(1, (len + span - 1) / span);
  if (spans == 1) return;
  const int g = gi / head_chunks;
  const int r0 = (gi - g * head_chunks) * hpb;
  const int nh = min(hpb, rep - r0);
  const int prow = min(rep, hpb);
  const int stride = partial_floats(prow, D);
  const float* row_part =
      part + ((static_cast<long long>(b) * groups + gi) * maxspans) * stride;
  QT* out_row = out + (static_cast<long long>(b) * H + g * rep + r0) * D;

  for (int q4 = threadIdx.x; q4 < nh * D / 4; q4 += kThreads) {
    const int i = 4 * q4;                 // first of 4 outputs, one head
    const int h = i / D;
    float M = kNegInf, L = 0.f;
    float A[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < spans; j0 += kChunk) {
      float mv[kChunk], lv[kChunk];
      float4 av[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float* pj = row_part + (j0 + u) * stride;
        const bool live = j0 + u < spans;
        mv[u] = live ? pj[prow * D + h] : kNegInf;
        lv[u] = live ? pj[prow * D + prow + h] : 0.f;
        av[u] = live ? *reinterpret_cast<const float4*>(pj + i)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (j0 + u >= spans) break;
        const float m_new = fmaxf(M, mv[u]);
        const float a = ex2(M - m_new);
        const float w = ex2(mv[u] - m_new);
        L = L * a + lv[u] * w;
        A[0] = A[0] * a + av[u].x * w;
        A[1] = A[1] * a + av[u].y * w;
        A[2] = A[2] * a + av[u].z * w;
        A[3] = A[3] * a + av[u].w * w;
        M = m_new;
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-9f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out_row[i + e] = from_float<QT>(A[e] * inv);
  }
}

// --- the simple route -------------------------------------------------------

// What a simple-route block needs to copy stages of one item's span.
template <typename KVT>
struct Span {
  const KVT* k_cache;
  const KVT* v_cache;
  const int* pages;                       // the span's page ids (shared)
  int c0, c1;                             // the span's columns [c0, c1)
  int block_size, Hkv, g, D, n_chunks;    // n_chunks: 16-byte chunks a row
};

// Stage j of the span (TS tokens) into ring slot j % kStages: thread i
// copies the 16-byte chunks i, i + kThreads, ... of the stage's K rows and
// V rows; tokens past c1 are zero-filled, not read.
template <typename KVT, int TS>
__device__ __forceinline__ void issue_stage(const Span<KVT>& sp, KVT* ring,
                                            int j) {
  constexpr int VEC = Layout<KVT>::kVec;
  KVT* slot = ring + (j % kStages) * 2 * TS * sp.D;
  for (int i = threadIdx.x; i < TS * sp.n_chunks; i += kThreads) {
    const int t = i / sp.n_chunks;
    const int ch = i - t * sp.n_chunks;
    const int local = j * TS + t;         // token within the span
    const bool live = sp.c0 + local < sp.c1;
    const long long page = live ? sp.pages[local / sp.block_size] : 0;
    const long long at =
        ((page * sp.block_size + local % sp.block_size) * sp.Hkv + sp.g) *
            sp.D + ch * VEC;
    cp_async16(smem_u32(slot + t * sp.D + ch * VEC),
               live ? sp.k_cache + at : sp.k_cache, live);
    cp_async16(smem_u32(slot + (TS + t) * sp.D + ch * VEC),
               live ? sp.v_cache + at : sp.v_cache, live);
  }
}


// Grid (min(B * maxspans * G, SMs * occupancy)), kThreads threads, where
// G = Hkv * ceil(rep / HPB).  Item i is (row-span i / G, head group i % G);
// the group serves the query heads h0 .. h0 + nh - 1 (nh <= HPB) of KV head
// g.  CPL: 16-byte loads per lane per token row.  `part` holds B * G *
// maxspans * partial_floats(min(rep, HPB), D) floats of span partials.
// (Two blocks an SM in the bound: with none, ptxas spilled 4 bytes in the
// 1-head bf16 variants; with 3 or 4, in the 4-head D = 256 bf16 ones.)
template <typename QT, typename KVT, int CPL, int HPB>
__global__ void __launch_bounds__(kThreads, 2) paged_decode_simple_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_cache,
    const KVT* __restrict__ v_cache, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, QT* __restrict__ out,
    float* __restrict__ part, int B, int H, int Hkv, int D, int block_size,
    int W, int span, int maxspans, float scale) {
  constexpr int G_LANES = Layout<KVT>::kGroup;
  constexpr int VEC = Layout<KVT>::kVec;
  constexpr int GPW = 32 / G_LANES;       // lane groups per warp
  constexpr int NG = kThreads / G_LANES;  // lane groups per block
  constexpr int TS = stage_tokens<KVT>();
  extern __shared__ __align__(16) unsigned char pda_smem[];
  KVT* ring = reinterpret_cast<KVT*>(pda_smem);
  float* acc_s = reinterpret_cast<float*>(pda_smem);  // after the walk
  __shared__ int pages_s[kMaxSpanPages];
  __shared__ Item item_s;
  __shared__ float m_s[NG * HPB];
  __shared__ float l_s[NG * HPB];

  const int rep = H / Hkv;
  const int head_chunks = (rep + HPB - 1) / HPB;
  const int groups = Hkv * head_chunks;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gw = (tid & 31) / G_LANES;    // group within the warp
  const int grp = warp * GPW + gw;
  const int lane = tid & (G_LANES - 1);
  const int n_chunks = D / VEC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const float qscale = scale * kLog2e;    // scores in the log2 domain
  for (int it = blockIdx.x;; it += gridDim.x) {
    if (warp == 0)
      locate_item(&item_s, seq_lens, B, W * block_size, span, it / groups,
                  tid & 31);
    __syncthreads();
    const Item item = item_s;
    if (it >= item.total * groups) break;  // uniform: every thread reads it
    const int b = item.row;
    const int gi = it - (it / groups) * groups;
    const int g = gi / head_chunks;
    const int r0 = (gi - g * head_chunks) * HPB;
    const int nh = min(HPB, rep - r0);
    const int h0 = g * rep + r0;
    const int c0 = item.span * span;      // a multiple of block_size
    const int c1 = min(item.len, c0 + span);
    const int npages = c1 > c0 ? (c1 - c0 + block_size - 1) / block_size : 0;
    const int nst = c1 > c0 ? (c1 - c0 + TS - 1) / TS : 0;

    const int* table = block_tables + static_cast<long long>(b) * W +
                       c0 / block_size;
    for (int i = tid; i < npages; i += kThreads) pages_s[i] = table[i];

    // this lane's slice of each query head, pre-scaled (its loads overlap
    // the page ids')
    float qr[HPB][CPL * VEC];
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int chunk = lane + cc * G_LANES;
        const bool live = h < nh && chunk < n_chunks;
        const long long at =
            (static_cast<long long>(b) * H + h0 + h) * D + chunk * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[h][cc * VEC + e] = live ? to_float(q[at + e]) * qscale : 0.f;
      }
    }
    __syncthreads();  // pages_s

    const Span<KVT> walk{k_cache, v_cache, pages_s, c0, c1, block_size, Hkv,
                         g, D, n_chunks};
    float acc[HPB][CPL * VEC];
    float m[HPB], l[HPB];
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < CPL * VEC; ++e) acc[h][e] = 0.f;
    }

    // one commit group per stage, empty ones included, so that waiting for
    // kStages - 2 groups in flight means stage j has landed
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < nst) issue_stage<KVT, TS>(walk, ring, j);
      cp_async_commit();
    }
    for (int j = 0; j < nst; ++j) {
      cp_async_wait<kStages - 2>();
      // stage j is in every thread's view, and every group is done with
      // stage j - 1, whose slot the next issue refills
      __syncthreads();
      if (j + kStages - 1 < nst)
        issue_stage<KVT, TS>(walk, ring, j + kStages - 1);
      cp_async_commit();

      const KVT* kb = ring + (j % kStages) * 2 * TS * D;
      const KVT* vb = kb + TS * D;
      const int tbase = grp * kTokPerGroup;        // within the stage
      const int cbase = c0 + j * TS + tbase;       // its column
      uint4 kr[kTokPerGroup][CPL], vr[kTokPerGroup][CPL];
#pragma unroll
      for (int u = 0; u < kTokPerGroup; ++u) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          const int chunk = lane + cc * G_LANES;
          const bool ok = chunk < n_chunks;
          const int at = (tbase + u) * D + chunk * VEC;
          kr[u][cc] = ok ? *reinterpret_cast<const uint4*>(kb + at) : zero;
          vr[u][cc] = ok ? *reinterpret_cast<const uint4*>(vb + at) : zero;
        }
      }

      // scores: lane-partial dot products, summed over the lane group
      float s[kTokPerGroup][HPB];
#pragma unroll
      for (int u = 0; u < kTokPerGroup; ++u) {
#pragma unroll
        for (int h = 0; h < HPB; ++h) s[u][h] = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          float kf[VEC];
          unpack(kr[u][cc], kf);
#pragma unroll
          for (int h = 0; h < HPB; ++h)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              s[u][h] += qr[h][cc * VEC + e] * kf[e];
        }
#pragma unroll
        for (int h = 0; h < HPB; ++h)
#pragma unroll
          for (int off = G_LANES / 2; off > 0; off >>= 1)
            s[u][h] += __shfl_xor_sync(0xffffffffu, s[u][h], off);
      }

      // online softmax over this group's tokens
      float p[kTokPerGroup][HPB];
#pragma unroll
      for (int h = 0; h < HPB; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kTokPerGroup; ++u)
          if (cbase + u < c1) mx = fmaxf(mx, s[u][h]);
        const float m_new = fmaxf(m[h], mx);
        const float alpha = ex2(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kTokPerGroup; ++u) {
          p[u][h] = cbase + u < c1 ? ex2(s[u][h] - m_new) : 0.f;
          sum += p[u][h];
        }
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int e = 0; e < CPL * VEC; ++e) acc[h][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kTokPerGroup; ++u) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          float vf[VEC];
          unpack(vr[u][cc], vf);
#pragma unroll
          for (int h = 0; h < HPB; ++h)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[h][cc * VEC + e] += p[u][h] * vf[e];
        }
      }
    }
    cp_async_wait<0>();  // only empty groups can be left
    __syncthreads();     // the ring is free for the group states

#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      if (lane == 0) {
        m_s[grp * HPB + h] = m[h];
        l_s[grp * HPB + h] = l[h];
      }
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int chunk = lane + cc * G_LANES;
        if (chunk < n_chunks) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc_s[(grp * HPB + h) * D + chunk * VEC + e] =
                acc[h][cc * VEC + e];
        }
      }
    }
    __syncthreads();
    finish_item<QT>(acc_s, m_s, l_s, NG, HPB, out, part, item, H, h0, nh, D,
                    gi, groups, maxspans, min(rep, HPB));
    __syncthreads();  // item_s, pages_s and the ring are reused
  }
}

// --- the mma route ----------------------------------------------------------

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of rows of
// `row_bytes`: the chunk index is XORed with row % 8, so the 8 rows an
// ldmatrix reads at one column fall in 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk, int row_bytes) {
  return row * row_bytes + ((chunk ^ (row & 7)) << 4);
}

// Grid (min(B * maxspans * G, SMs * occupancy * kWaves)), kThreads threads,
// where G = Hkv * ceil(rep / 16).  Item i is (row-span i / G, head group
// i % G): query heads h0 .. h0 + nh - 1 (nh <= 16) of KV head g, the rows of
// the products (rows past nh are zeros).  Shared memory holds Q (16 rows)
// and the span (span <= 128 tokens) whole, K rows then V rows, 2D bytes a
// row, swizzled: warp w copies and computes the 16-token stages 2w and
// 2w + 1, tokens [32w, 32w + 32) of the span, and waits on its own copies
// only.  `part` holds B * G * maxspans * partial_floats(min(rep, 16), D)
// floats of span partials.
template <int D>
__global__ void __launch_bounds__(kThreads, 3) paged_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int B, int H,
    int Hkv, int block_size, int W, int span, int maxspans, float scale) {
  constexpr int ROW = 2 * D;              // bytes of a row
  constexpr int KSTEPS = D / 16;          // k16 steps of S = Q.K^T
  constexpr int NT = D / 8;               // n8 tiles of O = P.V
  constexpr int CHUNKS = D / 8;           // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char pda_smem[];
  const uint32_t q_base = smem_u32(pda_smem);
  const uint32_t k_base = q_base + kMmaRows * ROW;
  const uint32_t v_base = k_base + kMmaSpan * ROW;
  float* acc_s = reinterpret_cast<float*>(pda_smem);  // after the walk
  __shared__ Item item_s;
  __shared__ float m_s[4 * kMmaRows];
  __shared__ float l_s[4 * kMmaRows];

  const int rep = H / Hkv;
  const int head_chunks = (rep + kMmaRows - 1) / kMmaRows;
  const int groups = Hkv * head_chunks;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g4 = lane >> 2;               // fragment row (and row + 8)
  const int t4 = lane & 3;                // fragment column pair
  const float qscale = scale * kLog2e;    // scores in the log2 domain
  for (int it = blockIdx.x;; it += gridDim.x) {
    if (warp == 0)
      locate_item(&item_s, seq_lens, B, W * block_size, span, it / groups,
                  lane);
    __syncthreads();
    const Item item = item_s;
    if (it >= item.total * groups) break;  // uniform: every thread reads it
    const int b = item.row;
    const int gi = it - (it / groups) * groups;
    const int g = gi / head_chunks;
    const int r0 = (gi - g * head_chunks) * kMmaRows;
    const int nh = min(kMmaRows, rep - r0);
    const int h0 = g * rep + r0;
    const int c0 = item.span * span;      // a multiple of block_size
    const int c1 = min(item.len, c0 + span);
    const int w0 = 32 * warp;             // this warp's first token, in span

    // the page of token w0 + lane (0 past the row's end: never read)
    int page = 0;
    if (c0 + w0 + lane < c1)
      page = block_tables[static_cast<long long>(b) * W +
                          (c0 + w0 + lane) / block_size];

    // Q into shared memory: heads h0 + row, zeros past nh (two bf16 a word)
    const __nv_bfloat16* q_row = q + (static_cast<long long>(b) * H + h0) * D;
    for (int i = tid; i < kMmaRows * D / 2; i += kThreads) {
      const int row = i / (D / 2);
      const int col = 2 * (i - row * (D / 2));
      uint32_t v = 0u;
      if (row < nh) {
        const unsigned short* at =
            reinterpret_cast<const unsigned short*>(q_row + row * D + col);
        v = at[0] | static_cast<uint32_t>(at[1]) << 16;
      }
      *reinterpret_cast<uint32_t*>(pda_smem + swz(row, col / 8, ROW) +
                                   (col % 8) * 2) = v;
    }

    // copy this warp's two stages, one commit group each (empty past the
    // row's end); lane l takes the 16-byte chunks l, l + 32, ... of the
    // stage's 16 K rows and V rows
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (c0 + w0 + 16 * s < c1) {         // uniform over the warp
#pragma unroll
        for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
          const int idx = i * 32 + lane;
          const int t = idx / CHUNKS;     // token within the stage
          const int ch = idx - t * CHUNKS;
          const int tok = w0 + 16 * s + t;  // within the span
          const bool live = c0 + tok < c1;
          const long long pg = __shfl_sync(0xffffffffu, page, 16 * s + t);
          const long long at =
              ((pg * block_size + tok % block_size) * Hkv + g) * D + ch * 8;
          const uint32_t dst = swz(tok, ch, ROW);
          cp_async16(k_base + dst, live ? k_cache + at : k_cache, live);
          cp_async16(v_base + dst, live ? v_cache + at : v_cache, live);
        }
      }
      cp_async_commit();
    }
    __syncthreads();  // Q

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf};      // rows g4 and g4 + 8
    float l[2] = {0.f, 0.f};              // this thread's columns only
    // ldmatrix rows: lane l addresses row l % 8 of matrix l / 8
    const int lrow = lane & 7;
    const int hi8 = (lane >> 3) & 1;      // matrix 1 or 3
    const int hi16 = lane >> 4;           // matrix 2 or 3

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int tb = w0 + 16 * s;         // the stage's first token, in span
      if (c0 + tb >= c1) break;           // uniform over the warp
      if (s == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncwarp();

      // S = Q.K^T over the stage's 16 tokens: two n8 tiles.  Q's A
      // fragment: matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15); K's B
      // fragments: (tokens 0-7 | 8-15) x (dims 0-7 | 8-15) of the step.
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4], r[4];
        ldsm_x4(qa, q_base + swz(lrow + 8 * hi8, 2 * kk + hi16, ROW));
        ldsm_x4(r, k_base + swz(tb + lrow + 8 * hi16, 2 * kk + hi8, ROW));
        mma_bf16(sc[0], qa, r[0], r[1]);
        mma_bf16(sc[1], qa, r[2], r[3]);
      }

      // online softmax of rows g4 (e = 0, 1) and g4 + 8 (e = 2, 3)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = c0 + tb + 8 * n + 2 * t4 + (e & 1) < c1;
          sc[n][e] = live ? sc[n][e] * qscale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t ph[4], pl[4];              // P as bf16 high and low parts
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = sc[n][e] > 0.5f * kNegInf ? ex2(sc[n][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += p[e];
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float a = p[2 * hf], c = p[2 * hf + 1];
          const uint32_t hi = pack_bf16(a, c);
          const __nv_bfloat162 hb =
              *reinterpret_cast<const __nv_bfloat162*>(&hi);
          ph[2 * n + hf] = hi;
          pl[2 * n + hf] =
              pack_bf16(a - __low2float(hb), c - __high2float(hb));
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P.V: V's rows are the k dimension, read transposed, matrices
      // (tokens 0-7 | 8-15) x (dims 0-7 | 8-15) of two n8 tiles
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t r[4];
        ldsm_x4_t(r, v_base + swz(tb + lrow + 8 * hi8, 2 * n2 + hi16, ROW));
        mma_bf16(acc[2 * n2], ph, r[0], r[1]);
        mma_bf16(acc[2 * n2], pl, r[0], r[1]);
        mma_bf16(acc[2 * n2 + 1], ph, r[2], r[3]);
        mma_bf16(acc[2 * n2 + 1], pl, r[2], r[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    cp_async_wait<0>();  // nothing of this thread's stays in flight
    __syncthreads();     // every warp is done with Q, K and V: acc_s reuses

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g4 + 8 * r;
      if (row >= nh) continue;
      if (t4 == 0) {
        m_s[warp * kMmaRows + row] = m[r];
        l_s[warp * kMmaRows + row] = l[r];
      }
      float* dst = acc_s + (warp * kMmaRows + row) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        dst[8 * n] = acc[n][2 * r];
        dst[8 * n + 1] = acc[n][2 * r + 1];
      }
    }
    __syncthreads();
    finish_item<__nv_bfloat16>(acc_s, m_s, l_s, 4, kMmaRows, out, part, item,
                               H, h0, nh, D, gi, groups, maxspans,
                               min(rep, kMmaRows));
    __syncthreads();  // item_s and shared memory are reused
  }
}

// --- host -------------------------------------------------------------------

// Opts a kernel into more than 48 KB of shared memory where it needs it
// (once per device: *opted holds a bit per device ordinal), and reads once
// (into *occ) how many of its blocks an SM holds.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, unsigned long long* opted,
                    int* occ) {
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(*opted & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      *opted |= bit;
    }
  }
  if (*occ == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    *occ = max(n, 1);
  }
  return cudaSuccess;
}

// Launches the walk `run` over rows [0, B) in slices of at most `rows` rows,
// each followed by paged_decode_combine_kernel when a row can have more
// than one span (part holds one slice's partials; the slices run in stream
// order).  A walk's grid holds at most `waves` blocks for each one an SM
// keeps resident.
template <typename QT, typename Run>
cudaError_t launch_slices(Run run, int occ, const int* seq_lens, QT* out,
                          float* part, int B, int H, int Hkv, int D,
                          int block_size, int W, int span, int rows, int hpb,
                          int sms, int waves, cudaStream_t stream) {
  const int maxspans = max(1, (W * block_size + span - 1) / span);
  const int rep = H / Hkv;
  const int groups = Hkv * ((rep + hpb - 1) / hpb);
  for (int b0 = 0; b0 < B; b0 += rows) {
    const int nb = min(rows, B - b0);
    const long long items = static_cast<long long>(nb) * maxspans * groups;
    const int grid = static_cast<int>(
        min(items, static_cast<long long>(sms) * occ * waves));
    run(grid, b0, nb, maxspans);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (maxspans == 1) continue;
    const long long qo = static_cast<long long>(b0) * H * D;
    paged_decode_combine_kernel<QT><<<nb * groups, kThreads, 0, stream>>>(
        part, seq_lens + b0, out + qo, H, Hkv, D, W * block_size, span,
        maxspans, hpb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename QT, typename KVT, int CPL, int HPB>
cudaError_t launch_simple(const QT* q, const KVT* k_cache,
                          const KVT* v_cache, const int* block_tables,
                          const int* seq_lens, QT* out, float* part, int B,
                          int H, int Hkv, int D, int block_size, int W,
                          int span, int rows, int sms, float scale,
                          cudaStream_t stream) {
  auto kernel = paged_decode_simple_kernel<QT, KVT, CPL, HPB>;
  static int occupancy[kMaxD / 8] = {0};   // by D / 8 - 1
  static unsigned long long opted[kMaxD / 8] = {0};
  const int smem = ring_bytes<KVT>(D);
  const cudaError_t err =
      prepare(kernel, smem, &opted[D / 8 - 1], &occupancy[D / 8 - 1]);
  if (err != cudaSuccess) return err;
  auto run = [&](int grid, int b0, int nb, int maxspans) {
    const long long qo = static_cast<long long>(b0) * H * D;
    kernel<<<grid, kThreads, smem, stream>>>(
        q + qo, k_cache, v_cache,
        block_tables + static_cast<long long>(b0) * W, seq_lens + b0,
        out + qo, part, nb, H, Hkv, D, block_size, W, span, maxspans, scale);
  };
  return launch_slices<QT>(run, occupancy[D / 8 - 1], seq_lens, out, part, B,
                           H, Hkv, D, block_size, W, span, rows, HPB, sms,
                           kWaves, stream);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k_cache, const void* v_cache,
                       const void* block_tables, const void* seq_lens,
                       void* out, void* part, int B, int H, int Hkv,
                       int block_size, int W, int span, int rows, int sms,
                       float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto kernel = paged_decode_mma_kernel<D>;
  static int occupancy = 0;
  static unsigned long long opted = 0;
  const int smem = (kMmaRows + 2 * kMmaSpan) * 2 * D;
  const cudaError_t err = prepare(kernel, smem, &opted, &occupancy);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(seq_lens);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  auto run = [&](int grid, int b0, int nb, int maxspans) {
    const long long qo = static_cast<long long>(b0) * H * D;
    kernel<<<grid, kThreads, smem, stream>>>(
        qt + qo, static_cast<const T*>(k_cache),
        static_cast<const T*>(v_cache),
        tables + static_cast<long long>(b0) * W, lens + b0, o + qo, p, nb, H,
        Hkv, block_size, W, span, maxspans, scale);
  };
  return launch_slices<T>(run, occupancy, lens, o, p, B, H, Hkv, D,
                          block_size, W, span, rows, kMmaRows, sms, kWaves,
                          stream);
}

// Picks the loads per lane (CPL) from D and the heads per block (HPB) from
// the GQA group.
template <typename QT, typename KVT>
cudaError_t simple_shape(const void* q, const void* k_cache,
                         const void* v_cache, const void* block_tables,
                         const void* seq_lens, void* out, void* part, int B,
                         int H, int Hkv, int D, int block_size, int W,
                         int span, int rows, int sms, float scale,
                         cudaStream_t stream) {
  constexpr int G = Layout<KVT>::kGroup;
  constexpr int VEC = Layout<KVT>::kVec;
  const int cpl = (D / VEC + G - 1) / G;
  const int hpb = heads_per_block(H / Hkv);
#define PDA_LAUNCH(C, P)                                                     \
  return launch_simple<QT, KVT, C, P>(                                       \
      static_cast<const QT*>(q), static_cast<const KVT*>(k_cache),          \
      static_cast<const KVT*>(v_cache),                                      \
      static_cast<const int*>(block_tables),                                 \
      static_cast<const int*>(seq_lens), static_cast<QT*>(out),              \
      static_cast<float*>(part), B, H, Hkv, D, block_size, W, span, rows,    \
      sms, scale, stream)
  if (cpl == 1) {
    if (hpb == 1) PDA_LAUNCH(1, 1);
    if (hpb == 2) PDA_LAUNCH(1, 2);
    PDA_LAUNCH(1, 4);
  }
  if (hpb == 1) PDA_LAUNCH(2, 1);
  if (hpb == 2) PDA_LAUNCH(2, 2);
  PDA_LAUNCH(2, 4);
#undef PDA_LAUNCH
}

}  // namespace

extern "C" {

// Both entries launch on `stream` and return cudaGetLastError() (0 on
// success).  The caller has checked shapes, types, devices, contiguity and
// 16-byte alignment; B >= 1, W >= 1, span a multiple of block_size, 1 <=
// rows.  With more than one span to a table (W * block_size > span), part
// holds min(B, rows) * G * ceil(W * block_size / span) *
// partial_floats(min(rep, HPB), D) floats of scratch, 16-byte aligned (G =
// Hkv * ceil(rep / HPB), rep = H / Hkv; HPB: 16 for the mma route,
// heads_per_block(rep) for the simple one); otherwise part may be null.
// sms: the device's SM count.

// The simple route: D a multiple of 8 up to 256, span at most 128 pages;
// q_bf16 / kv_bf16: 0 for fp32, 1 for bf16.
int paged_decode_attention_launch(const void* q, const void* k_cache,
                                  const void* v_cache, const void* block_tables,
                                  const void* seq_lens, void* out,
                                  void* part, int B, int H, int Hkv, int D,
                                  int block_size, int W, int span, int rows,
                                  int q_bf16, int kv_bf16, int sms,
                                  float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0 || span % block_size != 0 ||
      span / block_size > kMaxSpanPages || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16) {
    err = simple_shape<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part, B, H, Hkv,
        D, block_size, W, span, rows, sms, scale, s);
  } else if (q_bf16) {
    err = simple_shape<__nv_bfloat16, float>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part, B, H, Hkv,
        D, block_size, W, span, rows, sms, scale, s);
  } else if (kv_bf16) {
    err = simple_shape<float, __nv_bfloat16>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part, B, H, Hkv,
        D, block_size, W, span, rows, sms, scale, s);
  } else {
    err = simple_shape<float, float>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part, B, H, Hkv,
        D, block_size, W, span, rows, sms, scale, s);
  }
  return static_cast<int>(err);
}

// The mma route: bf16 q and pools, D 64 or 128, span at most 128 tokens.
int paged_decode_attention_mma_launch(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* block_tables,
                                      const void* seq_lens, void* out,
                                      void* part, int B, int H, int Hkv,
                                      int D, int block_size, int W, int span,
                                      int rows, int sms, float scale,
                                      void* stream) {
  if ((D != 64 && D != 128) || span % block_size != 0 || span > kMmaSpan ||
      rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D == 64 ? launch_mma<64>(q, k_cache, v_cache, block_tables, seq_lens,
                               out, part, B, H, Hkv, block_size, W, span,
                               rows, sms, scale, s)
              : launch_mma<128>(q, k_cache, v_cache, block_tables, seq_lens,
                                out, part, B, H, Hkv, block_size, W, span,
                                rows, sms, scale, s);
  return static_cast<int>(err);
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
