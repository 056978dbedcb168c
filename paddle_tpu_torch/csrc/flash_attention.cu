// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of paddle_tpu/ops/pallas_flash.py:
//   flash_attention_fwd_launch     <- _fwd_kernel     (launched by _flash_fwd)
//   flash_attention_bwd_dq_launch  <- _bwd_dq_kernel  (launched by _flash_bwd)
//   flash_attention_bwd_dkv_launch <- _bwd_dkv_kernel (launched by _flash_bwd)
//
//   q        [B, Sq, H, D]    fp32 or bf16, read through strides (d contiguous)
//   k, v     [B, Sk, Hkv, D]  q's dtype; query head h reads KV head h / (H/Hkv)
//   out, dq  [B, Sq, H, D]    q's dtype
//   dk, dv   [B, Sk, Hkv, D]  k's dtype
//   lse      [B, H, Sq]       fp32 log-sum-exp of the scaled scores
//   delta    [B, H, Sq]       fp32 rowsum(dO * O), computed by the caller
//
// What they compute is the TPU kernels' arithmetic: scores s = (q . k) * scale
// in fp32; with causal, the top-left mask row >= col fills s with -1e30; the
// online softmax keeps (m, l, acc) in fp32 and guards l == 0 with 1;
// p is rounded to v's dtype before the P.V product, dS to k's (dQ) or q's
// (dK) dtype and P to dO's dtype (dV) before the last products, all of which
// accumulate in fp32.  Keys at or past Sk and query rows at or past Sq (the
// ragged edge of the last tile) weigh nothing, so any Sq and Sk work.
//
// What bounds them on an H100: the operations.  At a training shape (S =
// 4096, D = 128) each kernel does O(S^2 D) multiply-adds on O(S D) bytes,
// hundreds of operations a byte, far above the card's ridge.  What the design
// does about it:
//   * one block owns a 64-row tile and loops over the other side's 64-row
//     tiles in place of the TPU's sequential grid axis (blocks here run in
//     parallel, in no order; nothing carries from one block to another);
//   * bf16 inputs (training) take the tensor cores: mma.sync m16n8k16 with
//     fp32 accumulators, 4 warps of 16 rows each, P and dS kept in registers
//     between the two products of a tile (see the bf16 section below);
//   * fp32 inputs take fp32 FMAs from shared memory (fp32 has no tensor-core
//     path that keeps its precision): the tiles live in shared memory as fp32
//     rows padded by one word, so a warp's reads fall in distinct banks or
//     broadcast; each thread keeps a 4 x 4 block of the 64 x 64 score tile
//     and a 4 x D/16 block of its output in registers, 16 FMAs for 8 loads;
//   * causal blocks skip the tiles above the diagonal (the TPU's `run`
//     condition), and the heaviest tiles are scheduled first;
//   * dK/dV has one block per (batch, KV tile, KV head) that walks the group's
//     query heads and the query tiles from the diagonal on, accumulating in
//     registers and writing once: no atomics, so results are deterministic.
// Left to later work: loads that overlap the products (cp.async or TMA),
// wgmma, and sharing a K/V tile among a GQA group's query heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kTile = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // 16 x 16 threads, each 4 rows x 4 columns
constexpr int kPStride = kTile + 1;
constexpr float kNegInf = -1e30f;

// Element strides of a [B, S, heads, D] tensor whose last dim is contiguous.
struct Strides {
  long long b, s, h;
};

// fp32 inputs: the FMA kernels.
//
// Rows [r0, r0 + 64) of head h, batch b, into a [64][D + 1] fp32 tile; rows
// at or past S are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          Strides st, int b, int h, int r0,
                                          int S) {
  const float* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? base[row * st.s + d] : 0.f;
  }
}

// s[i][j] = sum_d A[ty*4 + i][d] * B[tx + 16 j][d]: a 64 x 64 tile of A . B^T
// over two [64][D + 1] tiles.
template <int D>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         float (&s)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[ty*4 + i][c] * X[c][tx + 16 j]: a 64 x 64 tile P
// ([64][65]) times a [64][D + 1] tile X.
template <int D>
__device__ __forceinline__ void mul_tile(const float* P, const float* X,
                                         float (&acc)[4][D / 16], int ty,
                                         int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty * 4 + i) * kPStride + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float x = X[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// Max and sum over the 16 threads (tx) that share a row: lanes l and l ^ m for
// m < 16 lie in the same half-warp, which holds one ty.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// The number of key tiles query tile qi visits: under the top-left causal
// mask, the tiles that start at or before the tile's last row.
__device__ __forceinline__ int key_tiles(int qi, int Sk, int causal) {
  const int nk = (Sk + kTile - 1) / kTile;
  return causal ? min(nk, qi + 1) : nk;
}

// ---------------------------------------------------------------------------
// forward: grid (n_q, H, B); tile qi = n_q - 1 - blockIdx.x (longest first)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, Strides os, int H, int Hkv, int Sq, int Sk,
                     float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = qi * kTile;

  load_tile<D>(Qs, q, qs, b, h, q0, Sq);

  float acc[4][D / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(qi, Sk, causal);
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<D>(Ks, k, ks, b, g, kj * kTile, Sk);
    load_tile<D>(Vs, v, vs, b, g, kj * kTile, Sk);
    __syncthreads();
    float s[4][4];
    dot_rows<D>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kj * kTile + tx + 16 * j;
        const bool keep = !causal || row >= col;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        if (col < Sk) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kj * kTile + tx + 16 * j;
        const float p = col < Sk ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mul_tile<D>(Ps, Vs, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    float* o = out + b * os.b + row * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[tx + 16 * j] = acc[i][j] / safe_l;
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + row] =
          m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (n_q, H, B); dq = sum over key tiles of dS . K, with
// P = exp(s - lse), dP = dO . V^T, dS = P * (dP - delta) * scale
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, int H, int Hkv, int Sq, int Sk,
                        float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (D + 1);
  float* Ks = dOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = qi * kTile;
  const long long stat = (static_cast<long long>(b) * H + h) * Sq;

  load_tile<D>(Qs, q, qs, b, h, q0, Sq);
  load_tile<D>(dOs, dout, dos, b, h, q0, Sq);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < Sq ? lse[stat + row] : 0.f;
    delta_r[i] = row < Sq ? delta[stat + row] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int nk = key_tiles(qi, Sk, causal);
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();
    load_tile<D>(Ks, k, ks, b, g, kj * kTile, Sk);
    load_tile<D>(Vs, v, vs, b, g, kj * kTile, Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_rows<D>(Qs, Ks, s, ty, tx);
    dot_rows<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kj * kTile + tx + 16 * j;
        const bool keep = !causal || row >= col;
        const float sc = keep ? s[i][j] * scale : kNegInf;
        const float p = (col < Sk && row < Sq) ? expf(sc - lse_r[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        Ps[(ty * 4 + i) * kPStride + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    mul_tile<D>(Ps, Ks, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    float* o = dq + b * dqs.b + row * dqs.s + h * dqs.h;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// dK / dV: grid (n_k, Hkv, B).  The block holds key tile kj of KV head g and
// walks the group's query heads and the query tiles from the diagonal on;
// each thread owns 4 key rows.  With S^T = K . Q^T and dP^T = V . dO^T:
// dV += P^T . dO and dK += dS^T . Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dks, Strides dvs,
                         int H, int Hkv, int Sq, int Sk, float scale,
                         int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);
  float* lse_s = Ps + kTile * kPStride;
  float* delta_s = lse_s + kTile;

  const int kj = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int k0 = kj * kTile;
  const int nq = (Sq + kTile - 1) / kTile;
  const int q_first = causal ? kj : 0;  // tiles with (qi + 1) * 64 > kj * 64

  load_tile<D>(Ks, k, ks, b, g, k0, Sk);
  load_tile<D>(Vs, v, vs, b, g, k0, Sk);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int gi = 0; gi < rep; ++gi) {
    const int h = g * rep + gi;
    const long long stat = (static_cast<long long>(b) * H + h) * Sq;
    for (int qi = q_first; qi < nq; ++qi) {
      const int q0 = qi * kTile;
      __syncthreads();  // the previous tile's Q, dO and P are consumed
      load_tile<D>(Qs, q, qs, b, h, q0, Sq);
      load_tile<D>(dOs, dout, dos, b, h, q0, Sq);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Sq ? lse[stat + row] : 0.f;
        delta_s[threadIdx.x] = row < Sq ? delta[stat + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_rows<D>(Ks, Qs, s, ty, tx);    // s[i][j] = S^T[key][query]
      dot_rows<D>(Vs, dOs, dp, ty, tx);  // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int row = q0 + c;
          const bool keep = !causal || row >= key;
          const float sc = keep ? s[i][j] * scale : kNegInf;
          const float p =
              (row < Sq && key < Sk) ? expf(sc - lse_s[c]) : 0.f;
          Ps[(ty * 4 + i) * kPStride + c] = p;
          s[i][j] = p * (dp[i][j] - delta_s[c]) * scale;  // dS^T
        }
      }
      __syncthreads();
      mul_tile<D>(Ps, dOs, dv_acc, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty * 4 + i) * kPStride + tx + 16 * j] = s[i][j];
      __syncthreads();
      mul_tile<D>(Ps, Qs, dk_acc, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
    float* ok = dk + b * dks.b + key * dks.s + g * dks.h;
    float* ov = dv + b * dvs.b + key * dvs.s + g * dvs.h;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      ok[tx + 16 * j] = dk_acc[i][j];
      ov[tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ===========================================================================
// bf16: the same three kernels on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators).  A block of 4 warps owns a 64-row tile; each
// warp owns 16 of its rows and the whole 64-column tile of the other side.
// Tiles stay bf16 in shared memory, rows padded by 8 elements so that the
// fragment loads of a warp fall in distinct banks.  A score tile comes out
// of the tensor core in the C-fragment layout, which is the A-fragment
// layout of the next product: P (or dS) is rounded to bf16 in registers and
// multiplied without going through shared memory.  The B operands of the
// second products (V, K, dO, Q, read along their rows' other axis) come from
// the same row-major tiles through ldmatrix.trans.
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;

// d += a * b over one m16n8k16 step (row-major A, column-major B).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [m0, m0 + 16) and columns [k0, k0 + 16) of a
// row-major tile with row stride ST (g = lane / 4, t = lane % 4).
template <int ST>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int m0, int k0, int g, int t) {
  const bf16* p = tile + (m0 + g) * ST + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ST);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ST + 8);
}

// B = X^T for rows [n0, n0 + 8) and columns [k0, k0 + 16) of a row-major
// tile X: the B fragment of a product against the tile's rows.
template <int ST>
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* tile, int n0, int k0,
                                        int g, int t) {
  const bf16* p = tile + (n0 + g) * ST + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B = X for rows [k0, k0 + 16) and columns [n0, n0 + 16) of a row-major tile
// X, as the B fragments of two 8-column steps: b[0], b[1] for n0 and b[2],
// b[3] for n0 + 8.
template <int ST>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile,
                                             int k0, int n0, int lane) {
  const bf16* p =
      tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ST + n0 + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Rows [r0, r0 + 64) of head h, batch b, into a [64][D + 8] bf16 tile; rows
// at or past S are zeros.  vec: every row starts on 16 bytes (one 16-byte
// load per 8 values), else element loads.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst,
                                               const bf16* __restrict__ src,
                                               Strides st, int b, int h, int r0,
                                               int S, int vec) {
  constexpr int ST = D + 8;
  constexpr int kChunks = D / 8;
  const bf16* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) {
      const bf16* p = base + row * st.s + c * 8;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        __align__(16) bf16 tmp[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) tmp[i] = p[i];
        val = *reinterpret_cast<const uint4*>(tmp);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ST + c * 8) = val;
  }
}

// The sum of x over the 4 threads (t = lane % 4) that hold one row of a C
// fragment, and their max.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// s[j] (n-tile j of 8 columns, C layout) = A rows [m0, m0 + 16) of tile At
// times the rows of tile Bt, over D: a 16 x 64 tile of At . Bt^T.
template <int D>
__device__ __forceinline__ void mma_rows(float (&s)[8][4], const bf16* At,
                                         int m0, const bf16* Bt, int g,
                                         int t) {
  constexpr int ST = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<ST>(a, At, m0, kk * 16, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      load_bt<ST>(b0, b1, Bt, j * 8, kk * 16, g, t);
      mma_bf16(s[j], a, b0, b1);
    }
  }
}

// acc[n] (n-tile n of 8 columns of D) += P . X, with P the 16 x 64 tile held
// in C layout in p (rounded to bf16 here) and X rows [0, 64) of a tile.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&p)[8][4], const bf16* X,
                                       int lane) {
  constexpr int ST = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      load_b_trans<ST>(b, X, kk * 16, n2 * 16, lane);
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// forward, bf16: grid (n_q, H, B), 4 warps; tile qi = n_q - 1 - blockIdx.x.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, Strides qs, Strides ks,
                         Strides vs, Strides os, int H, int Hkv, int Sq, int Sk,
                         float scale, int causal, int vec) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bytes);
  bf16* Ks = Qs + kTile * ST;
  bf16* Vs = Ks + kTile * ST;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qi * kTile;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile_bf16<D>(Qs, q, qs, b, h, q0, Sq, vec);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int nk = key_tiles(qi, Sk, causal);
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_tile_bf16<D>(Ks, k, ks, b, kv, kj * kTile, Sk, vec);
    load_tile_bf16<D>(Vs, v, vs, b, kv, kj * kTile, Sk, vec);
    __syncthreads();
    float s[8][4];
    mma_rows<D>(s, Qs, warp * 16, Ks, g, t);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kj * kTile + j * 8 + 2 * t + e;
          float& x = s[j][2 * hf + e];
          x = (!causal || rows[hf] >= col) ? x * scale : kNegInf;
          if (col < Sk) mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hf], quad_max(mx));
      const float corr = expf(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kj * kTile + j * 8 + 2 * t + e;
          float& x = s[j][2 * hf + e];
          x = col < Sk ? expf(x - m_new) : 0.f;
          sum += x;
        }
      l[hf] = l[hf] * corr + quad_sum(sum);
      m[hf] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * hf] *= corr;
        acc[n][2 * hf + 1] *= corr;
      }
    }
    mma_pv<D>(acc, s, Vs, lane);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rows[hf];
    if (row >= Sq) continue;
    const float safe_l = l[hf] == 0.f ? 1.f : l[hf];
    bf16* o = out + b * os.b + row * os.s + h * os.h + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][2 * hf] / safe_l, acc[n][2 * hf + 1] / safe_l);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + row] =
          m[hf] + logf(safe_l);
  }
}

// dQ, bf16: grid (n_q, H, B), 4 warps.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, Strides qs, Strides ks,
                            Strides vs, Strides dos, Strides dqs, int H,
                            int Hkv, int Sq, int Sk, float scale, int causal,
                            int vec) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bytes);
  bf16* dOs = Qs + kTile * ST;
  bf16* Ks = dOs + kTile * ST;
  bf16* Vs = Ks + kTile * ST;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qi * kTile;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long stat = (static_cast<long long>(b) * H + h) * Sq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lse_r[hf] = rows[hf] < Sq ? lse[stat + rows[hf]] : 0.f;
    delta_r[hf] = rows[hf] < Sq ? delta[stat + rows[hf]] : 0.f;
  }

  load_tile_bf16<D>(Qs, q, qs, b, h, q0, Sq, vec);
  load_tile_bf16<D>(dOs, dout, dos, b, h, q0, Sq, vec);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int nk = key_tiles(qi, Sk, causal);
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();
    load_tile_bf16<D>(Ks, k, ks, b, kv, kj * kTile, Sk, vec);
    load_tile_bf16<D>(Vs, v, vs, b, kv, kj * kTile, Sk, vec);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_rows<D>(s, Qs, warp * 16, Ks, g, t);
    mma_rows<D>(dp, dOs, warp * 16, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1;
        const int col = kj * kTile + j * 8 + 2 * t + (c & 1);
        const float sc = (!causal || rows[hf] >= col) ? s[j][c] * scale : kNegInf;
        const float p =
            (col < Sk && rows[hf] < Sq) ? expf(sc - lse_r[hf]) : 0.f;
        s[j][c] = p * (dp[j][c] - delta_r[hf]) * scale;  // dS
      }
    mma_pv<D>(acc, s, Ks, lane);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rows[hf];
    if (row >= Sq) continue;
    bf16* o = dq + b * dqs.b + row * dqs.s + h * dqs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][2 * hf], acc[n][2 * hf + 1]);
  }
}

// dK / dV, bf16: grid (n_k, Hkv, B), 4 warps, each owning 16 key rows of
// the block's key tile; the query tile is taken kCols columns at a time to
// keep S^T and dP^T small beside the two D-wide accumulators.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             Strides qs, Strides ks, Strides vs, Strides dos,
                             Strides dks, Strides dvs, int H, int Hkv, int Sq,
                             int Sk, float scale, int causal, int vec) {
  constexpr int ST = D + 8;
  // query columns a step: as many as the registers hold beside the two
  // D-wide accumulators (at D = 128, 32 columns spill)
  constexpr int kCols = D == 128 ? 16 : 32;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_bytes);
  bf16* Vs = Ks + kTile * ST;
  bf16* Qs = Vs + kTile * ST;
  bf16* dOs = Qs + kTile * ST;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * ST);
  float* delta_s = lse_s + kTile;

  const int kj = blockIdx.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kj * kTile;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const int nq = (Sq + kTile - 1) / kTile;
  const int q_first = causal ? kj : 0;

  load_tile_bf16<D>(Ks, k, ks, b, kv, k0, Sk, vec);
  load_tile_bf16<D>(Vs, v, vs, b, kv, k0, Sk, vec);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  for (int gi = 0; gi < rep; ++gi) {
    const int h = kv * rep + gi;
    const long long stat = (static_cast<long long>(b) * H + h) * Sq;
    for (int qi = q_first; qi < nq; ++qi) {
      const int q0 = qi * kTile;
      __syncthreads();  // the previous tile's Q and dO are consumed
      load_tile_bf16<D>(Qs, q, qs, b, h, q0, Sq, vec);
      load_tile_bf16<D>(dOs, dout, dos, b, h, q0, Sq, vec);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Sq ? lse[stat + row] : 0.f;
        delta_s[threadIdx.x] = row < Sq ? delta[stat + row] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int c0 = 0; c0 < kTile; c0 += kCols) {
        // S^T and dP^T for query columns [c0, c0 + kCols)
        float s[kCols / 8][4], dp[kCols / 8][4];
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          load_a<ST>(ak, Ks, warp * 16, kk * 16, g, t);
          load_a<ST>(av, Vs, warp * 16, kk * 16, g, t);
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j) {
            uint32_t b0, b1;
            load_bt<ST>(b0, b1, Qs, c0 + j * 8, kk * 16, g, t);
            mma_bf16(s[j], ak, b0, b1);
            load_bt<ST>(b0, b1, dOs, c0 + j * 8, kk * 16, g, t);
            mma_bf16(dp[j], av, b0, b1);
          }
        }
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = keys[c >> 1];
            const int qc = c0 + j * 8 + 2 * t + (c & 1);
            const int row = q0 + qc;
            const float sc = (!causal || row >= key) ? s[j][c] * scale : kNegInf;
            const float p =
                (row < Sq && key < Sk) ? expf(sc - lse_s[qc]) : 0.f;
            s[j][c] = p;                                         // P^T
            dp[j][c] = p * (dp[j][c] - delta_s[qc]) * scale;     // dS^T
          }
        // dV += P^T . dO and dK += dS^T . Q over these query rows
#pragma unroll
        for (int kk = 0; kk < kCols / 16; ++kk) {
          const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const uint32_t ads[4] = {
              pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
          for (int n2 = 0; n2 < D / 16; ++n2) {
            uint32_t bb[4];
            load_b_trans<ST>(bb, dOs, c0 + kk * 16, n2 * 16, lane);
            mma_bf16(dv_acc[2 * n2], ap, bb[0], bb[1]);
            mma_bf16(dv_acc[2 * n2 + 1], ap, bb[2], bb[3]);
            load_b_trans<ST>(bb, Qs, c0 + kk * 16, n2 * 16, lane);
            mma_bf16(dk_acc[2 * n2], ads, bb[0], bb[1]);
            mma_bf16(dk_acc[2 * n2 + 1], ads, bb[2], bb[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = keys[hf];
    if (key >= Sk) continue;
    bf16* ok = dk + b * dks.b + key * dks.s + kv * dks.h + 2 * t;
    bf16* ov = dv + b * dvs.b + key * dvs.s + kv * dvs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ok + n * 8) =
          pack_bf16(dk_acc[n][2 * hf], dk_acc[n][2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(ov + n * 8) =
          pack_bf16(dv_acc[n][2 * hf], dv_acc[n][2 * hf + 1]);
    }
  }
}

// Shared memory of each kernel: fp32 tiles of 64 rows padded to D + 1, the
// 64 x 65 P / dS tile and, for dK/dV, the tile's lse and delta.
constexpr int tile_bytes(int D) { return kTile * (D + 1) * 4; }
constexpr int p_bytes() { return kTile * kPStride * 4; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Whether every row of the input tensors starts on 16 bytes (the pointer
// and the b, s and head strides): the bf16 kernels then load 16 bytes at a
// time.  `st` holds the inputs' strides first, in the same order.
int rows_aligned(std::initializer_list<const void*> inputs,
                 const long long* st) {
  int i = 0;
  for (const void* p : inputs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] % 8) return 0;
    ++i;
  }
  return 1;
}

// bf16 shared memory: tiles of 64 rows padded to D + 8 bf16.
constexpr int mma_tile_bytes(int D) { return kTile * (D + 8) * 2; }

// The host side of each kernel: fp32 inputs take the FMA kernels, bf16
// inputs the tensor-core ones.
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const long long* st, int B, int H, int Hkv, int Sq,
                int Sk, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    const int bytes = 3 * mma_tile_bytes(D);
    auto kernel = flash_fwd_mma_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), H, Hkv, Sq, Sk, scale, causal,
        rows_aligned({q, k, v}, st));
  } else {
    const int bytes = 3 * tile_bytes(D) + p_bytes();
    auto kernel = flash_fwd_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), H, Hkv, Sq, Sk, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const long long* st, int B, int H, int Hkv,
                   int Sq, int Sk, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    const int bytes = 4 * mma_tile_bytes(D);
    auto kernel = flash_bwd_dq_mma_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), H, Hkv, Sq,
        Sk, scale, causal, rows_aligned({q, k, v, dout}, st));
  } else {
    const int bytes = 4 * tile_bytes(D) + p_bytes();
    auto kernel = flash_bwd_dq_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), H, Hkv, Sq,
        Sk, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const long long* st, int B, int H,
                    int Hkv, int Sq, int Sk, float scale, int causal,
                    cudaStream_t stream) {
  const dim3 grid((Sk + kTile - 1) / kTile, Hkv, B);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    const int bytes = 4 * mma_tile_bytes(D) + 2 * kTile * 4;
    auto kernel = flash_bwd_dkv_mma_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), strides_at(st, 0),
        strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
        strides_at(st, 4), strides_at(st, 5), H, Hkv, Sq, Sk, scale, causal,
        rows_aligned({q, k, v, dout}, st));
  } else {
    const int bytes = 4 * tile_bytes(D) + p_bytes() + 2 * kTile * 4;
    auto kernel = flash_bwd_dkv_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), strides_at(st, 0),
        strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
        strides_at(st, 4), strides_at(st, 5), H, Hkv, Sq, Sk, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// Picks the instantiation for (dtype, D); D is 64 or 128.
#define FA_DISPATCH(FN, ...)                                              \
  do {                                                                    \
    cudaError_t err_;                                                     \
    if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue); \
    if (bf16)                                                             \
      err_ = D == 64 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)                 \
                     : FN<__nv_bfloat16, 128>(__VA_ARGS__);               \
    else                                                                  \
      err_ = D == 64 ? FN<float, 64>(__VA_ARGS__)                         \
                     : FN<float, 128>(__VA_ARGS__);                       \
    return static_cast<int>(err_);                                        \
  } while (0)

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller has checked devices, dtypes (all of q's: fp32 or bf16; lse and
// delta fp32 and contiguous), shapes (H a multiple of Hkv >= 1; B, Sq, Sk
// >= 1) and that the last dim of every [B, S, heads, D] tensor is
// contiguous.  `strides` holds (b, s, head) element strides of the tensors in
// argument order.  bf16: 0 for fp32, 1 for bf16.

int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, const long long* strides,
                               int B, int H, int Hkv, int Sq, int Sk, int D,
                               int bf16, int causal, float scale,
                               void* stream) {
  FA_DISPATCH(fwd, q, k, v, out, lse, strides, B, H, Hkv, Sq, Sk, scale,
              causal, static_cast<cudaStream_t>(stream));
}

int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq,
                                  const long long* strides, int B, int H,
                                  int Hkv, int Sq, int Sk, int D, int bf16,
                                  int causal, float scale, void* stream) {
  FA_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, strides, B, H, Hkv, Sq,
              Sk, scale, causal, static_cast<cudaStream_t>(stream));
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv,
                                   const long long* strides, int B, int H,
                                   int Hkv, int Sq, int Sk, int D, int bf16,
                                   int causal, float scale, void* stream) {
  FA_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, strides, B, H, Hkv,
              Sq, Sk, scale, causal, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
