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
// Everything is accumulated in fp32 and written in q's dtype.  Pages at or
// past ceil(seq_lens[b] / bs) are never read, so a table padded far past a
// row's length (the decode-burst tables are) costs nothing.  A pad row (len 1,
// all-null table) reads page 0, which holds finite values, so its output is
// finite.  A row with seq_lens == 0 reads nothing and gets zeros (the TPU
// kernel gives zeros too: acc 0 over max(l, 1e-9)); the engine never builds
// one.
//
// What bounds it on an H100: the bytes.  Each row's live K and V pages are
// read once per KV head (GQA: the H / Hkv query heads of a group share one
// read), against ~4 flops a K/V element, far below the card's rate: q, out
// and the live pages over 3.35 TB/s is the floor.  What the design does
// about it:
//   * a group of lanes reads one K or V token row with 16-byte loads
//     (16 lanes for bf16 at D = 128, a whole warp for fp32), and each lane
//     loads kTok tokens of K and of V before it uses any, so 2 * kTok
//     16-byte loads are in flight per lane;
//   * no barrier inside the walk: every lane group keeps its own online
//     softmax state (max, sum, fp32 accumulator in registers) over its own
//     tokens, and the groups are merged once at the end, in a fixed order;
//   * the row's tokens are split over blockIdx.z (flash-decoding) so that
//     even a batch of a few rows puts a couple of blocks on every SM; with
//     more than one split a second kernel merges the splits.  The split
//     count depends only on the batch and head shapes, never on the table
//     width or the data, so a row's result does not depend on how far its
//     table is padded.
// Summation order is fixed, so equal inputs give equal outputs.  Tensor
// cores, TMA and a persistent schedule are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTok = 4;         // tokens a lane group loads per step
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

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

// Grid (B, Hkv * head_chunks, splits), kThreads threads.  The block serves
// row b, the query heads h0 .. h0 + nh - 1 (nh <= HPB) of KV head g, and the
// columns [c0, c1) of split blockIdx.z.  CPL: 16-byte loads per lane per row.
template <typename QT, typename KVT, int CPL, int HPB>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_cache,
    const KVT* __restrict__ v_cache, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, QT* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int H,
    int Hkv, int D, int block_size, int W, float scale) {
  constexpr int G = Layout<KVT>::kGroup;
  constexpr int VEC = Layout<KVT>::kVec;
  constexpr int GPW = 32 / G;             // lane groups per warp
  constexpr int NG = kThreads / G;        // lane groups per block
  __shared__ float acc_s[NG * HPB * kMaxD];
  __shared__ float m_s[NG * HPB];
  __shared__ float l_s[NG * HPB];

  const int b = blockIdx.x;
  const int rep = H / Hkv;
  const int head_chunks = (rep + HPB - 1) / HPB;
  const int g = blockIdx.y / head_chunks;
  const int r0 = (blockIdx.y - g * head_chunks) * HPB;
  const int nh = min(HPB, rep - r0);
  const int h0 = g * rep + r0;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gw = (tid & 31) / G;          // group within the warp
  const int grp = warp * GPW + gw;
  const int lane = tid & (G - 1);
  const int n_chunks = D / VEC;

  // the block loads its own routing: no scalar prefetch on this card
  int len = min(seq_lens[b], W * block_size);
  len = max(len, 0);
  const int per = (len + nsplit - 1) / nsplit;
  const int c0 = min(len, static_cast<int>(blockIdx.z) * per);
  const int c1 = min(len, c0 + per);
  const int* table = block_tables + static_cast<long long>(b) * W;

  // this lane's slice of each query head, pre-scaled
  float qr[HPB][CPL * VEC];
#pragma unroll
  for (int h = 0; h < HPB; ++h) {
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int chunk = lane + cc * G;
      const bool live = h < nh && chunk < n_chunks;
      const long long base =
          (static_cast<long long>(b) * H + h0 + h) * D + chunk * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[h][cc * VEC + e] = live ? to_float(q[base + e]) * scale : 0.f;
    }
  }

  float acc[HPB][CPL * VEC];
  float m[HPB], l[HPB];
#pragma unroll
  for (int h = 0; h < HPB; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL * VEC; ++e) acc[h][e] = 0.f;
  }

  // The loop bound is uniform across a warp (the shuffles below need every
  // lane); tokens at or past c1 are loaded by nobody and weigh nothing.
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int wbase = c0 + warp * GPW * kTok; wbase < c1;
       wbase += NG * kTok) {
    const int base = wbase + gw * kTok;
    uint4 kr[kTok][CPL], vr[kTok][CPL];
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
      const int c = base + t;
      const bool live = c < c1;
      const long long page = live ? table[c / block_size] : 0;
      const long long row =
          ((page * block_size + (live ? c % block_size : 0)) * Hkv + g) * D;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int chunk = lane + cc * G;
        const bool load = live && chunk < n_chunks;
        const long long at = row + chunk * VEC;
        kr[t][cc] = load ? *reinterpret_cast<const uint4*>(k_cache + at) : zero;
        vr[t][cc] = load ? *reinterpret_cast<const uint4*>(v_cache + at) : zero;
      }
    }

    // scores: lane-partial dot products, summed over the lane group
    float s[kTok][HPB];
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
#pragma unroll
      for (int h = 0; h < HPB; ++h) s[t][h] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float kf[VEC];
        unpack(kr[t][cc], kf);
#pragma unroll
        for (int h = 0; h < HPB; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[t][h] += qr[h][cc * VEC + e] * kf[e];
      }
#pragma unroll
      for (int h = 0; h < HPB; ++h)
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          s[t][h] += __shfl_xor_sync(0xffffffffu, s[t][h], off);
    }

    // online softmax over this group's tokens
    float p[kTok][HPB];
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kTok; ++t)
        if (base + t < c1) mx = fmaxf(mx, s[t][h]);
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
        p[t][h] = base + t < c1 ? expf(s[t][h] - m_new) : 0.f;
        sum += p[t][h];
      }
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int e = 0; e < CPL * VEC; ++e) acc[h][e] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float vf[VEC];
        unpack(vr[t][cc], vf);
#pragma unroll
        for (int h = 0; h < HPB; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[h][cc * VEC + e] += p[t][h] * vf[e];
      }
    }
  }

  // merge the lane groups, in group order
#pragma unroll
  for (int h = 0; h < HPB; ++h) {
    if (lane == 0) {
      m_s[grp * HPB + h] = m[h];
      l_s[grp * HPB + h] = l[h];
    }
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int chunk = lane + cc * G;
      if (chunk < n_chunks) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc_s[(grp * HPB + h) * D + chunk * VEC + e] = acc[h][cc * VEC + e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += kThreads) {
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
    const long long bh = static_cast<long long>(b) * H + h0 + h;
    if (nsplit == 1) {
      out[bh * D + d] = from_float<QT>(A / fmaxf(L, 1e-9f));
    } else {
      const long long slot = bh * nsplit + blockIdx.z;
      part_acc[slot * D + d] = A;
      if (d == 0) {
        part_ml[2 * slot] = M;
        part_ml[2 * slot + 1] = L;
      }
    }
  }
}

// Grid (B * H), kThreads threads: merges the splits of one (row, head).
template <typename QT>
__global__ void __launch_bounds__(kThreads) combine_splits_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    QT* __restrict__ out, int D, int nsplit) {
  const long long bh = blockIdx.x;
  const float* ml = part_ml + 2 * bh * nsplit;
  float M = kNegInf;
  for (int z = 0; z < nsplit; ++z) M = fmaxf(M, ml[2 * z]);
  float L = 0.f;
  for (int z = 0; z < nsplit; ++z) L += ml[2 * z + 1] * expf(ml[2 * z] - M);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float A = 0.f;
    for (int z = 0; z < nsplit; ++z)
      A += part_acc[(bh * nsplit + z) * D + d] * expf(ml[2 * z] - M);
    out[bh * D + d] = from_float<QT>(A / fmaxf(L, 1e-9f));
  }
}

template <typename QT, typename KVT, int CPL, int HPB>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* block_tables, const void* seq_lens, void* out,
                   void* part_acc, void* part_ml, int B, int H, int Hkv,
                   int D, int block_size, int W, int nsplit, float scale,
                   cudaStream_t stream) {
  const int head_chunks = (H / Hkv + HPB - 1) / HPB;
  const dim3 grid(B, Hkv * head_chunks, nsplit);
  paged_decode_kernel<QT, KVT, CPL, HPB><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_cache),
      static_cast<const KVT*>(v_cache), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<QT*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, Hkv, D,
      block_size, W, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_splits_kernel<QT><<<B * H, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<QT*>(out), D, nsplit);
  return cudaGetLastError();
}

// Picks the loads per lane (CPL) from D and the heads per block (HPB) from
// the GQA group: groups wider than 4 heads are split over blockIdx.y.
template <typename QT, typename KVT>
cudaError_t launch_shape(const void* q, const void* k_cache,
                         const void* v_cache, const void* block_tables,
                         const void* seq_lens, void* out, void* part_acc,
                         void* part_ml, int B, int H, int Hkv, int D,
                         int block_size, int W, int nsplit, float scale,
                         cudaStream_t stream) {
  constexpr int G = Layout<KVT>::kGroup;
  constexpr int VEC = Layout<KVT>::kVec;
  const int cpl = (D / VEC + G - 1) / G;
  const int rep = H / Hkv;
#define PDA_LAUNCH(C, P)                                                     \
  return launch<QT, KVT, C, P>(q, k_cache, v_cache, block_tables, seq_lens, \
                               out, part_acc, part_ml, B, H, Hkv, D,        \
                               block_size, W, nsplit, scale, stream)
  if (cpl == 1) {
    if (rep == 1) PDA_LAUNCH(1, 1);
    if (rep == 2) PDA_LAUNCH(1, 2);
    PDA_LAUNCH(1, 4);
  }
  if (rep == 1) PDA_LAUNCH(2, 1);
  if (rep == 2) PDA_LAUNCH(2, 2);
  PDA_LAUNCH(2, 4);
#undef PDA_LAUNCH
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, types, devices, contiguity and 16-byte
// alignment; B >= 1, W >= 1, D a multiple of 8 up to 256, 1 <= nsplit.
// With nsplit > 1, part_acc holds B * H * nsplit * D floats and part_ml
// B * H * nsplit * 2 (both scratch); with nsplit == 1 they may be null.
// q_bf16 / kv_bf16: 0 for fp32, 1 for bf16.
int paged_decode_attention_launch(const void* q, const void* k_cache,
                                  const void* v_cache, const void* block_tables,
                                  const void* seq_lens, void* out,
                                  void* part_acc, void* part_ml, int B, int H,
                                  int Hkv, int D, int block_size, int W,
                                  int nsplit, int q_bf16, int kv_bf16,
                                  float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16) {
    err = launch_shape<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part_acc, part_ml,
        B, H, Hkv, D, block_size, W, nsplit, scale, s);
  } else if (q_bf16) {
    err = launch_shape<__nv_bfloat16, float>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part_acc, part_ml,
        B, H, Hkv, D, block_size, W, nsplit, scale, s);
  } else if (kv_bf16) {
    err = launch_shape<float, __nv_bfloat16>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part_acc, part_ml,
        B, H, Hkv, D, block_size, W, nsplit, scale, s);
  } else {
    err = launch_shape<float, float>(
        q, k_cache, v_cache, block_tables, seq_lens, out, part_acc, part_ml,
        B, H, Hkv, D, block_size, W, nsplit, scale, s);
  }
  return static_cast<int>(err);
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
