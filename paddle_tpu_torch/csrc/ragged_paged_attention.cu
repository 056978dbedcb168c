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
// fp32, with the same update order and the same -1e30 mask constant:
//   m_new = max(m, max_c s_c); alpha = exp(m - m_new); p_c = exp(s_c - m_new)
//   l = l * alpha + sum_c p_c;  acc = acc * alpha + sum_c p_c v_c
// and the result acc / max(l, 1e-9) is written in q's dtype.
//
// What bounds it on an H100: for decode rows the K/V bytes read from device
// memory (each row's pages once, against ~4 flops per K/V element loaded);
// the arithmetic is far below the card's rate.  This first design is simple
// rather than fast.  One thread block serves one (token, KV head) pair and
// holds the H / Hkv query heads of that group (at most kMaxHeadsPerBlock; a
// larger group is split over blockIdx.z).  It walks the row's pages in order,
// staging the K and V page [bs, D] of its head in shared memory as fp32.  So
// a decode row reads its pages once per KV head, as the bound assumes, but a
// prefill chunk of n tokens re-reads each page once per token (n times), from
// L2 where it is still resident.  Sharing a page among the tokens of a chunk,
// tensor-core products and double-buffered loads are left to later work.
//
// Pad tokens point at a pad row whose table is all null pages (block 0) with
// kv_len 1: they read page 0, which holds finite values, so their output is
// finite and is never read by the engine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadsPerBlock = 8;
constexpr float kNegInf = -1e30f;

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
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
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
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* block_tables, const void* kv_lens,
                   const void* seg_ids, const void* q_pos, void* out, int T,
                   int H, int Hkv, int D, int block_size, int W, float scale,
                   cudaStream_t stream) {
  const int rep = H / Hkv;
  const int heads_per_block = rep < kMaxHeadsPerBlock ? rep : kMaxHeadsPerBlock;
  const size_t smem = sizeof(float) * smem_floats(heads_per_block, D, block_size);
  auto kernel = ragged_paged_attention_kernel<QT, KVT>;
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

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, types, devices and contiguity; T >= 1.
// q_bf16 / kv_bf16: 0 for fp32, 1 for bf16.
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
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k_cache, v_cache, block_tables,
                                               kv_lens, seg_ids, q_pos, out, T, H,
                                               Hkv, D, block_size, W, scale, s);
  } else if (q_bf16) {
    err = launch<__nv_bfloat16, float>(q, k_cache, v_cache, block_tables, kv_lens,
                                       seg_ids, q_pos, out, T, H, Hkv, D,
                                       block_size, W, scale, s);
  } else if (kv_bf16) {
    err = launch<float, __nv_bfloat16>(q, k_cache, v_cache, block_tables, kv_lens,
                                       seg_ids, q_pos, out, T, H, Hkv, D,
                                       block_size, W, scale, s);
  } else {
    err = launch<float, float>(q, k_cache, v_cache, block_tables, kv_lens,
                               seg_ids, q_pos, out, T, H, Hkv, D, block_size, W,
                               scale, s);
  }
  return static_cast<int>(err);
}

const char* ragged_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
