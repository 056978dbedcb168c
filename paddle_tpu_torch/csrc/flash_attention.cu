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
// in fp32; with causal, the top-left mask row >= col fills s with -1e30 (the
// TMA kernels use -inf, which weighs the same 0 in every row that has a
// key: all of them, since key 0 is never masked); the online softmax keeps
// (m, l, acc) in fp32 and guards l == 0 with 1;
// p is rounded to v's dtype before the P.V product, dS to k's (dQ) or q's
// (dK) dtype and P to dO's dtype (dV) before the last products, all of which
// accumulate in fp32.  Keys at or past Sk and query rows at or past Sq (the
// ragged edge of the last tile) weigh nothing, so any Sq and Sk work.
//
// What bounds them on an H100: the operations.  At a training shape (S =
// 4096, D = 128) each kernel does O(S^2 D) multiply-adds on O(S D) bytes,
// hundreds of operations a byte, far above the card's ridge.  What the design
// does about it:
//   * bf16 inputs (training) take Hopper kernels: TMA loads in flight in a
//     ring of shared-memory stages, two consumer warpgroups multiplying on
//     wgmma; the forward and dQ pack a GQA group's query heads into one
//     block, so each K/V tile is loaded once per group (see the section
//     "bf16 forward, dQ and dK/dV on Hopper");
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

using bf16 = __nv_bfloat16;

// ===========================================================================
// bf16 forward, dQ and dK/dV on Hopper: TMA loads into a ring of shared-memory
// stages, consumed by wgmma.  A block has two consumer warpgroups, each
// owning 64 rows of the block's tile.  Stage s of the ring has a `full`
// mbarrier (the issuing thread's arrival plus the TMA bytes) and an `empty`
// one (one arrival from each consumer warp once its wgmmas have read the
// stage).  One thread issues every TMA load: in the forward, the first
// thread of a ninth warp, the producer; in dQ and dK/dV, consumer thread 0,
// which refills a stage once every warp has released it.  The register file is
// split in four quarters over which the warps are spread, so a ninth warp
// caps every thread at 168 registers: the forward fits (168, no spills),
// dK/dV's two D-wide accumulators do not (at D = 128 it takes over 220 of
// the 255 that 8 warps allow).  setmaxnreg, which moves registers from a
// producer warpgroup to the consumers, did not lift ptxas's allocation
// above the cap for dK/dV, which still spilled.  Inputs are read through
// 4-d tensor maps over the [B, S, heads, D] tensors (dims D, heads, S,
// B): a box is 64 columns of D
// (128 bytes, the 128-byte swizzle the wgmma descriptors expect) by some
// heads by some rows, and D = 128 is two boxes side by side.  Rows past S
// come back as zeros; the kernels mask the keys and queries past the edge
// themselves, since a zero key still scores 0.
// ===========================================================================

constexpr int kConsumerWarps = 8;         // two warpgroups
constexpr int kFwdThreads = 32 * (kConsumerWarps + 1);   // + the producer
constexpr int kDkvThreads = 32 * kConsumerWarps;
constexpr int kStages = 2;                // ring depth
constexpr int kBox = 64;                  // bf16 columns of a TMA box
constexpr int kFwdRows = 128;             // rows of a forward block
constexpr int kFwdKeys = 128;             // keys of a forward K/V tile
constexpr int kDkvKeys = 128;             // keys of a dK/dV block
constexpr int kDkvRows = 64;              // query rows of a dK/dV Q/dO tile
constexpr int kDqRows = 128;              // rows of a dQ block
constexpr int kDqKeys = 64;               // keys of a dQ K/V tile
// A TMA box may only start on 16 bytes, so the lse and delta slice of a
// query tile is loaded from its start rounded down to 4 floats, 68 floats
// long, into a slot of 96 (128-byte-aligned slots).
constexpr int kStatBox = kDkvRows + 4;
constexpr int kStatSlot = 96;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Forward: replaces paddle_tpu/ops/pallas_flash.py::_fwd_kernel for bf16.
//
// Bound on an H100: the operations.  At the training shape (B = 2, S =
// 4096, H = 32, Hkv = 8, D = 128, causal) the two products are 275 GFLOP
// on 1.2 MB of q, k, v and out; at 989 TFLOP/s that is 0.28 ms, against
// 0.0004 ms for the bytes.  What the design does about it:
//   * one block per (batch, KV head, query tile).  Its 128 rows are the
//     group's rep query heads at 128 / rep positions each, row r = position
//     r / rep, head r % rep: in [B, S, H, D] those heads sit side by side,
//     so one TMA box (64, rep, 128 / rep) loads them, and each K/V tile
//     crosses from device memory to shared memory once per GQA group;
//   * the producer keeps K and V tiles in flight in a 2-stage ring while
//     the consumers multiply: S = Q.K^T on wgmma m64n128k16 with Q and K
//     from shared memory, then P (rounded to bf16 in registers) . V with V
//     read MN-major through the descriptor, no copy or transpose;
//   * scores stay fp32 in the exp2 domain, log2(e) * scale folded into one
//     FMA a score; masked scores are -inf and the max's base is 0 while a
//     row has seen no key, so they weigh exactly 0 (every row has key 0);
//     lse is written as a natural log, m * ln 2 + log l;
//   * causal blocks visit only the key tiles at or below their last row,
//     diagonal tile first, and mask only the tiles that cross the diagonal
//     or Sk; the blocks of the last query tiles (the most key tiles) are
//     launched first.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         Strides os, int B, int H, int Hkv, int Sq, int Sk,
                         float scale_log2, int causal) {
  using namespace hopper;
  constexpr int kBoxes = D / kBox;
  constexpr int kQBox = kFwdRows * 128;   // bytes of one box of the Q tile
  constexpr int kKBox = kFwdKeys * 128;   // ... of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + kBoxes * kQBox;               // [stage][box]
  unsigned char* Vs = Ks + kStages * kBoxes * kKBox;     // [stage][box]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * kBoxes * kKBox);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int rep = H / Hkv;
  const int per = kFwdRows / rep;     // query positions of the block
  const int rows = per * rep;         // rows in use (128 when rep | 128)
  const int n_bh = Hkv * B;
  const int n_q = (Sq + per - 1) / per;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int g = static_cast<int>(blockIdx.x) % n_bh % Hkv;
  const int b = static_cast<int>(blockIdx.x) % n_bh / Hkv;
  const int q0 = qt * per;
  const int q_last = min(q0 + per, Sq) - 1;
  const int key_end = causal ? min(Sk, q_last + 1) : Sk;
  const int nk = (key_end + kFwdKeys - 1) / kFwdKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumerWarps);
      mbar_init(v_empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {
    // the producer warp
    if (threadIdx.x == 32 * kConsumerWarps) {
      mbar_arrive_expect(q_full, rows * D * 2);
      for (int x = 0; x < kBoxes; ++x)
        tma_load_4d(Qs + x * kQBox, &tq, q_full, x * kBox, g * rep, q0, b);
      for (int it = 0; it < nk; ++it) {
        const int k0 = (nk - 1 - it) * kFwdKeys;
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_arrive_expect(k_full + st, kFwdKeys * D * 2);
        for (int x = 0; x < kBoxes; ++x)
          tma_load_4d(Ks + (st * kBoxes + x) * kKBox, &tk, k_full + st,
                      x * kBox, g, k0, b);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_arrive_expect(v_full + st, kFwdKeys * D * 2);
        for (int x = 0; x < kBoxes; ++x)
          tma_load_4d(Vs + (st * kBoxes + x) * kKBox, &tv, v_full + st,
                      x * kBox, g, k0, b);
      }
    }
  } else {
    // a consumer: rows [64 cw, 64 cw + 64) of the block
    const int cw = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int c = lane & 3;
    int pos[2], head[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = cw * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * i;
      pos[i] = q0 + r / rep;
      head[i] = g * rep + r % rep;
      live[i] = r < rows && pos[i] < Sq;
    }
    float o[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) o[n] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};   // this thread's part of each row's sum

    mbar_wait(q_full, 0);
    for (int it = 0; it < nk; ++it) {
      const int k0 = (nk - 1 - it) * kFwdKeys;
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      float s[kFwdKeys / 2];
      const uint32_t qa = smem_addr(Qs) + cw * 64 * 128;
      const uint32_t ka = smem_addr(Ks) + st * kBoxes * kKBox;
      mbar_wait(k_full + st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(s, kmajor(qa + (kk / 4) * kQBox + (kk % 4) * 32),
                      kmajor(ka + (kk / 4) * kKBox + (kk % 4) * 32), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_empty + st);

      if (k0 + kFwdKeys > Sk || (causal && k0 + kFwdKeys - 1 > q0)) {
#pragma unroll
        for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + 8 * j + 2 * c + e;
              if (col >= Sk || (causal && col > pos[i]))
                s[4 * j + 2 * i + e] = -INFINITY;
            }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kFwdKeys / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx) * scale_log2);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float corr = ex2(m[i] - base);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            x = ex2(fmaf(x, scale_log2, -base));
            sum += x;
          }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n + 2 * i] *= corr;
          o[4 * n + 2 * i + 1] *= corr;
        }
      }
      uint32_t pa[kFwdKeys / 16][4];
      to_a_frags<kFwdKeys / 16>(pa, s);
      fence_regs(o);
      const uint32_t va = smem_addr(Vs) + st * kBoxes * kKBox;
      mbar_wait(v_full + st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], mnmajor(va + kk * 16 * 128, kKBox));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty + st);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(l[i]);
      if (!live[i]) continue;
      const float safe_l = sum == 0.f ? 1.f : sum;
      bf16* orow = out + b * os.b + pos[i] * os.s + head[i] * os.h + 2 * c;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o[4 * n + 2 * i] / safe_l, o[4 * n + 2 * i + 1] / safe_l);
      if (c == 0)
        lse[(static_cast<long long>(b) * H + head[i]) * Sq + pos[i]] =
            m[i] * kLn2 + logf(safe_l);
    }
  }
}

// dK / dV: replaces paddle_tpu/ops/pallas_flash.py::_bwd_dkv_kernel for
// bf16.
//
// Bound on an H100: the operations.  At the training shape the four
// products (S^T, dP^T, dV, dK) are 550 GFLOP on 2.2 MB; at 989 TFLOP/s
// 0.56 ms.  What the design does about it:
//   * one block per (batch, KV head, 128-key tile); each consumer owns 64
//     keys and keeps its dK and dV accumulators (64 x D fp32 each) in
//     registers (over 220 a thread at D = 128, which is why the block has
//     no ninth, producer warp: consumer thread 0 issues the loads);
//     the K and V tiles are loaded once by TMA and stay in shared memory;
//   * the block walks the group's query heads and, for each, the 64-row
//     query tiles from the diagonal on; Q, dO and the tile's lse and delta
//     slices (1-d tensor maps over the flat [B, H, Sq] arrays) stream
//     through a 2-stage TMA ring;
//   * S^T = K.Q^T and dP^T = V.dO^T on wgmma m64n64k16 with K and V as the
//     shared-memory A operand; then dV += P^T.dO and dK += dS^T.Q with P^T
//     and dS^T rounded to bf16 in registers as the A operand and dO and Q
//     read MN-major from the same tiles;
//   * P = exp2(s * log2(e) * scale - lse * log2(e)), one FMA a score;
//   * each block writes its keys' dK and dV once: no atomics, so the
//     results are deterministic.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tlse,
                             const __grid_constant__ CUtensorMap tdelta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             Strides dks, Strides dvs, int B, int H, int Hkv,
                             int Sq, int Sk, float scale, int causal) {
  using namespace hopper;
  constexpr int kBoxes = D / kBox;
  constexpr int kKBox = kDkvKeys * 128;   // bytes of one box of K or V
  constexpr int kQBox = kDkvRows * 128;   // ... of a Q or dO tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + kBoxes * kKBox;
  unsigned char* Qs = Vs + kBoxes * kKBox;               // [stage][box]
  unsigned char* dOs = Qs + kStages * kBoxes * kQBox;    // [stage][box]
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * kBoxes * kQBox);
  float* delta_s = lse_s + kStages * kStatSlot;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + kStages * kStatSlot);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int rep = H / Hkv;
  const int n_bh = Hkv * B;
  const int kt = static_cast<int>(blockIdx.x) / n_bh;  // heaviest first
  const int g = static_cast<int>(blockIdx.x) % n_bh % Hkv;
  const int b = static_cast<int>(blockIdx.x) % n_bh / Hkv;
  const int k0 = kt * kDkvKeys;
  const int nq = (Sq + kDkvRows - 1) / kDkvRows;
  const int q_first = causal ? k0 / kDkvRows : 0;  // tiles holding q >= k0

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The block's walk: step it is query tile q_first + it % n_qt of the
  // group's query head it / n_qt, in stage it % kStages.
  const int n_qt = max(nq - q_first, 0);
  const int n_it = rep * n_qt;
  auto issue = [&](int it) {
    const int h = g * rep + it / n_qt;
    const int qt = q_first + it % n_qt;
    const int st = it % kStages;
    mbar_arrive_expect(full + st, 2 * kDkvRows * D * 2 + 2 * kStatBox * 4);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load_4d(Qs + (st * kBoxes + x) * kQBox, &tq, full + st, x * kBox, h,
                  qt * kDkvRows, b);
      tma_load_4d(dOs + (st * kBoxes + x) * kQBox, &tdo, full + st, x * kBox,
                  h, qt * kDkvRows, b);
    }
    const int flat = ((b * H + h) * Sq + qt * kDkvRows) & ~3;
    tma_load_1d(lse_s + st * kStatSlot, &tlse, full + st, flat);
    tma_load_1d(delta_s + st * kStatSlot, &tdelta, full + st, flat);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect(kv_full, 2 * kDkvKeys * D * 2);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load_4d(Ks + x * kKBox, &tk, kv_full, x * kBox, g, k0, b);
      tma_load_4d(Vs + x * kKBox, &tv, kv_full, x * kBox, g, k0, b);
    }
    for (int it = 0; it < min(kStages, n_it); ++it) issue(it);
  }
  __syncwarp();

  // consumer warpgroup cw owns keys [k0 + 64 cw, k0 + 64 cw + 64)
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t & 31;
  const int c = lane & 3;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    key[i] = k0 + cw * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * i;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dk_acc[n] = dv_acc[n] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int q0 = (q_first + it % n_qt) * kDkvRows;
    const int stat0 = (b * H + g * rep + it / n_qt) * Sq;
    float s[kDkvRows / 2], dp[kDkvRows / 2];
    const uint32_t ka = smem_addr(Ks) + cw * 64 * 128;
    const uint32_t qa = smem_addr(Qs) + st * kBoxes * kQBox;
    mbar_wait(full + st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor(ka + (kk / 4) * kKBox + (kk % 4) * 32),
                   kmajor(qa + (kk / 4) * kQBox + (kk % 4) * 32), kk);
    const uint32_t va = smem_addr(Vs) + cw * 64 * 128;
    const uint32_t da_ = smem_addr(dOs) + st * kBoxes * kQBox;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor(va + (kk / 4) * kKBox + (kk % 4) * 32),
                   kmajor(da_ + (kk / 4) * kQBox + (kk % 4) * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s = S^T (rows: keys, columns: this tile's queries) -> P^T,
    // dp = dP^T -> dS^T
    const bool edge = q0 + kDkvRows > Sq || k0 + kDkvKeys > Sk ||
                      (causal && q0 < k0 + kDkvKeys - 1);
    const int shift = (stat0 + q0) & 3;   // where the slice starts
    const float* lse_t = lse_s + st * kStatSlot + shift;
    const float* delta_t = delta_s + st * kStatSlot + shift;
#pragma unroll
    for (int j = 0; j < kDkvRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;
        const int q = q0 + col;
        const float lse2 = lse_t[col] * kLog2e;
        const float dl = delta_t[col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + e;
          float p = ex2(fmaf(s[x], scale_log2, -lse2));
          if (edge && !(q < Sq && key[i] < Sk && (!causal || q >= key[i])))
            p = 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - dl) * scale;
        }
      }
    uint32_t pa[kDkvRows / 16][4], da[kDkvRows / 16][4];
    to_a_frags<kDkvRows / 16>(pa, s);
    to_a_frags<kDkvRows / 16>(da, dp);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    const uint32_t doa = smem_addr(dOs) + st * kBoxes * kQBox;
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk)
      wgmma_rs<D>(dv_acc, pa[kk], mnmajor(doa + kk * 16 * 128, kQBox));
    const uint32_t qb = smem_addr(Qs) + st * kBoxes * kQBox;
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk)
      wgmma_rs<D>(dk_acc, da[kk], mnmajor(qb + kk * 16 * 128, kQBox));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (lane == 0) mbar_arrive(empty + st);
    // refill this stage with step it + kStages once every warp is done
    if (threadIdx.x == 0 && it + kStages < n_it) {
      mbar_wait(empty + st, ph);
      issue(it + kStages);
    }
    __syncwarp();   // the wgmmas ahead need the whole warp
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
    bf16* ok = dk + b * dks.b + key[i] * dks.s + g * dks.h + 2 * c;
    bf16* ov = dv + b * dvs.b + key[i] * dvs.s + g * dvs.h + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ok + 8 * n) =
          pack_bf16(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(ov + 8 * n) =
          pack_bf16(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

// dQ: replaces paddle_tpu/ops/pallas_flash.py::_bwd_dq_kernel for bf16.
//
// Bound on an H100: the operations.  At the training shape the three
// products (S, dP, dQ) are 412 GFLOP on 1.6 MB; at 989 TFLOP/s 0.42 ms.
// What the design does about it:
//   * the forward's block: one per (batch, KV head, 128 / rep query
//     positions), the group's rep heads packed into its 128 rows, so one
//     TMA box loads Q (and one dO) and each K/V tile crosses from device
//     memory once per GQA group;
//   * Q, dO and each row's lse and delta are loaded once; lse and delta by
//     plain loads into registers (two rows a thread);
//   * K and V stream through a 2-stage TMA ring of 64-key tiles.  For each
//     tile, S = Q.K^T and dP = dO.V^T on SS wgmma m64n64k16; P =
//     exp2(s * log2(e) * scale - lse * log2(e)) and dS = P * (dP - delta) *
//     scale in registers; dS rounded to bf16 (k's dtype) is the A operand
//     of dQ += dS.K on RS wgmma, with K read MN-major as the forward reads
//     V, from the tile already in shared memory;
//   * the dQ accumulator (64 x D fp32 a warpgroup), S and dP take about
//     180 registers a thread, over the 168 a ninth warp allows, so the
//     block is dK/dV's: 8 warps, consumer thread 0 issuing the loads and
//     refilling a stage once all 8 warps have released it;
//   * causal blocks visit only the key tiles at or below their last row
//     and mask only the tiles that cross the diagonal or Sk; the blocks of
//     the last query tiles (the most key tiles) are launched first;
//   * each row's dQ is written once: no atomics, so the result is
//     deterministic, and dK/dV stays a kernel of its own.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, Strides dqs, int B, int H,
                            int Hkv, int Sq, int Sk, float scale, int causal) {
  using namespace hopper;
  constexpr int kBoxes = D / kBox;
  constexpr int kQBox = kDqRows * 128;   // bytes of one box of Q or dO
  constexpr int kKBox = kDqKeys * 128;   // ... of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + kBoxes * kQBox;
  unsigned char* Ks = dOs + kBoxes * kQBox;              // [stage][box]
  unsigned char* Vs = Ks + kStages * kBoxes * kKBox;     // [stage][box]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * kBoxes * kKBox);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int rep = H / Hkv;
  const int per = kDqRows / rep;      // query positions of the block
  const int rows = per * rep;         // rows in use (128 when rep | 128)
  const int n_bh = Hkv * B;
  const int n_q = (Sq + per - 1) / per;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int g = static_cast<int>(blockIdx.x) % n_bh % Hkv;
  const int b = static_cast<int>(blockIdx.x) % n_bh / Hkv;
  const int q0 = qt * per;
  const int q_last = min(q0 + per, Sq) - 1;
  const int key_end = causal ? min(Sk, q_last + 1) : Sk;
  const int nk = (key_end + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int it) {
    const int st = it % kStages;
    mbar_arrive_expect(full + st, 2 * kDqKeys * D * 2);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load_4d(Ks + (st * kBoxes + x) * kKBox, &tk, full + st, x * kBox, g,
                  it * kDqKeys, b);
      tma_load_4d(Vs + (st * kBoxes + x) * kKBox, &tv, full + st, x * kBox, g,
                  it * kDqKeys, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect(q_full, 2 * rows * D * 2);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load_4d(Qs + x * kQBox, &tq, q_full, x * kBox, g * rep, q0, b);
      tma_load_4d(dOs + x * kQBox, &tdo, q_full, x * kBox, g * rep, q0, b);
    }
    for (int it = 0; it < min(kStages, nk); ++it) issue(it);
  }
  __syncwarp();

  // consumer warpgroup cw owns rows [64 cw, 64 cw + 64) of the block
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t & 31;
  const int c = lane & 3;
  int pos[2], head[2];
  bool live[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = cw * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * i;
    pos[i] = q0 + r / rep;
    head[i] = g * rep + r % rep;
    live[i] = r < rows && pos[i] < Sq;
    const long long at =
        (static_cast<long long>(b) * H + head[i]) * Sq + pos[i];
    lse2[i] = live[i] ? lse[at] * kLog2e : 0.f;
    dl[i] = live[i] ? delta[at] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kDqKeys;
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    float s[kDqKeys / 2], dp[kDqKeys / 2];
    const uint32_t qa = smem_addr(Qs) + cw * 64 * 128;
    const uint32_t doa = smem_addr(dOs) + cw * 64 * 128;
    const uint32_t ka = smem_addr(Ks) + st * kBoxes * kKBox;
    const uint32_t va = smem_addr(Vs) + st * kBoxes * kKBox;
    mbar_wait(full + st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor(qa + (kk / 4) * kQBox + (kk % 4) * 32),
                   kmajor(ka + (kk / 4) * kKBox + (kk % 4) * 32), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor(doa + (kk / 4) * kQBox + (kk % 4) * 32),
                   kmajor(va + (kk / 4) * kKBox + (kk % 4) * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s = S (rows: this block's queries, columns: the tile's keys) -> P,
    // dp = dP -> dS
    const bool edge = k0 + kDqKeys > Sk || (causal && k0 + kDqKeys - 1 > q0);
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * c + e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + e;
          float p = ex2(fmaf(s[x], scale_log2, -lse2[i]));
          if (edge && (col >= Sk || (causal && col > pos[i]))) p = 0.f;
          dp[x] = p * (dp[x] - dl[i]) * scale;
        }
      }
    uint32_t da[kDqKeys / 16][4];
    to_a_frags<kDqKeys / 16>(da, dp);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk)
      wgmma_rs<D>(acc, da[kk], mnmajor(ka + kk * 16 * 128, kKBox));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + st);
    // refill this stage with tile it + kStages once every warp is done
    if (threadIdx.x == 0 && it + kStages < nk) {
      mbar_wait(empty + st, ph);
      issue(it + kStages);
    }
    __syncwarp();   // the wgmmas ahead need the whole warp
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    bf16* o = dq + b * dqs.b + pos[i] * dqs.s + head[i] * dqs.h + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + 8 * n) =
          pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
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

// The tensor map of a bf16 [B, S, heads, D] tensor with element strides st:
// dims (D, heads, S, B), boxes of (64, box_heads, box_rows, 1) with the
// 128-byte swizzle; rows past S read as zeros.  TMA needs a 16-byte-aligned
// base and strides that are multiples of 16 bytes (the wrapper copies other
// inputs to contiguous ones first); the stride of a dim of extent 1 is never
// used and is replaced by its contiguous value.
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, Strides st, int B,
                     int S, int heads, int D, int box_heads, int box_rows) {
  const long long sh = heads > 1 ? st.h : D;
  const long long ss = S > 1 ? st.s : sh * heads;
  const long long sb = B > 1 ? st.b : ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  return hopper::bf16_map_4d(map, ptr, dims, strides, box);
}

// The tensor map of a flat fp32 array of n values (lse or delta, [B, H, Sq]
// contiguous) in boxes of kStatBox values, one dK/dV query tile's slice and
// the up to 3 values before it; values past n read as zeros.
cudaError_t stat_map(CUtensorMap* map, const void* ptr, long long n) {
  const hopper::EncodeTiled encode = hopper::encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t unused[1] = {static_cast<cuuint64_t>((n * 4 + 15) / 16 * 16)};
  const cuuint32_t box[1] = {kStatBox};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<void*>(ptr), dims, unused, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Dynamic shared memory of the TMA kernels: 1024 bytes of slack to align
// the tiles, the tiles, the lse and delta stages and the mbarriers.
constexpr int fwd_tma_bytes(int D) {
  return 1024 + (kFwdRows + 2 * kStages * kFwdKeys) * D * 2 +
         (1 + 4 * kStages) * 8;
}
constexpr int dkv_tma_bytes(int D) {
  return 1024 + (2 * kDkvKeys + 2 * kStages * kDkvRows) * D * 2 +
         2 * kStages * kStatSlot * 4 + (1 + 2 * kStages) * 8;
}
constexpr int dq_tma_bytes(int D) {
  return 1024 + (2 * kDqRows + 2 * kStages * kDqKeys) * D * 2 +
         (1 + 2 * kStages) * 8;
}

// The host side of each kernel: fp32 inputs take the FMA kernels, bf16
// inputs the TMA/wgmma kernels.  A GQA group packs into one block's 128
// rows, so the bf16 forward and dQ take at most 128 query heads a KV head
// (the wrapper refuses more before a launch).
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const long long* st, int B, int H, int Hkv, int Sq,
                int Sk, float scale, int causal, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    const int rep = H / Hkv;
    const int per = kFwdRows / rep;
    if (per < 1) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    if ((err = bf16_map(&tq, q, strides_at(st, 0), B, Sq, H, D, rep, per)) !=
            cudaSuccess ||
        (err = bf16_map(&tk, k, strides_at(st, 1), B, Sk, Hkv, D, 1,
                        kFwdKeys)) != cudaSuccess ||
        (err = bf16_map(&tv, v, strides_at(st, 2), B, Sk, Hkv, D, 1,
                        kFwdKeys)) != cudaSuccess)
      return err;
    const int bytes = fwd_tma_bytes(D);
    auto kernel = flash_fwd_tma_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    const int blocks = (Sq + per - 1) / per * Hkv * B;
    kernel<<<blocks, kFwdThreads, bytes, stream>>>(
        tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse),
        strides_at(st, 3), B, H, Hkv, Sq, Sk, scale * kLog2e, causal);
  } else {
    const dim3 grid((Sq + kTile - 1) / kTile, H, B);
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
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    const int rep = H / Hkv;
    const int per = kDqRows / rep;
    if (per < 1) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv, tdo;
    if ((err = bf16_map(&tq, q, strides_at(st, 0), B, Sq, H, D, rep, per)) !=
            cudaSuccess ||
        (err = bf16_map(&tk, k, strides_at(st, 1), B, Sk, Hkv, D, 1,
                        kDqKeys)) != cudaSuccess ||
        (err = bf16_map(&tv, v, strides_at(st, 2), B, Sk, Hkv, D, 1,
                        kDqKeys)) != cudaSuccess ||
        (err = bf16_map(&tdo, dout, strides_at(st, 3), B, Sq, H, D, rep,
                        per)) != cudaSuccess)
      return err;
    const int bytes = dq_tma_bytes(D);
    auto kernel = flash_bwd_dq_tma_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    const int blocks = (Sq + per - 1) / per * Hkv * B;
    kernel<<<blocks, kDkvThreads, bytes, stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq),
        strides_at(st, 4), B, H, Hkv, Sq, Sk, scale, causal);
  } else {
    const dim3 grid((Sq + kTile - 1) / kTile, H, B);
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
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
    if ((err = bf16_map(&tq, q, strides_at(st, 0), B, Sq, H, D, 1,
                        kDkvRows)) != cudaSuccess ||
        (err = bf16_map(&tk, k, strides_at(st, 1), B, Sk, Hkv, D, 1,
                        kDkvKeys)) != cudaSuccess ||
        (err = bf16_map(&tv, v, strides_at(st, 2), B, Sk, Hkv, D, 1,
                        kDkvKeys)) != cudaSuccess ||
        (err = bf16_map(&tdo, dout, strides_at(st, 3), B, Sq, H, D, 1,
                        kDkvRows)) != cudaSuccess ||
        (err = stat_map(&tlse, lse, static_cast<long long>(B) * H * Sq)) !=
            cudaSuccess ||
        (err = stat_map(&tdelta, delta, static_cast<long long>(B) * H * Sq)) !=
            cudaSuccess)
      return err;
    const int bytes = dkv_tma_bytes(D);
    auto kernel = flash_bwd_dkv_tma_kernel<D>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return err;
    const int blocks = (Sk + kDkvKeys - 1) / kDkvKeys * Hkv * B;
    kernel<<<blocks, kDkvThreads, bytes, stream>>>(
        tq, tk, tv, tdo, tlse, tdelta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), strides_at(st, 4), strides_at(st, 5), B, H,
        Hkv, Sq, Sk, scale, causal);
  } else {
    const dim3 grid((Sk + kTile - 1) / kTile, Hkv, B);
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
