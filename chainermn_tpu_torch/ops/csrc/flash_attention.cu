// Flash attention for training on Hopper's CUDA cores, sm_90a: the fp32
// forward (K2) and dk/dv (K4), and dq (K3) in fp32 and bf16.  The bf16 K2
// and K4 run on the tensor cores, in flash_attention_sm90.cu; fp32 stays
// here because a tensor-core product in fp32 means TF32 (10 bits of
// mantissa), which fails the fp32 tolerance (rtol 2^-20).
//
// Replaces the TPU kernels of chainermn_tpu/ops/pallas_attention.py:
//   flash_fwd      <- `_flash_fwd_kernel` (:367, launched by `_flash_forward`
//                     at :503), fp32
//   flash_bwd_dq   <- `_flash_bwd_dq_kernel` (:619, `_flash_backward` :878)
//   flash_bwd_dkv  <- `_flash_bwd_dkv_kernel` (:747, `_flash_backward` :895),
//                     fp32
// They compute the same functions, not the same blocks.  q, k, v, out and
// the gradients are (batch, seq, heads, d), indexed through the strides the
// wrapper passes (the last dim contiguous): no (b*h, s, d) copy and no
// padding.  lse and delta are fp32 (batch*heads, s_q).
//
// Numerics (as the TPU kernels): scores, P, dP, dS and every accumulator
// are fp32; masked scores are -1e30, not -inf; the forward pre-scales q by
// `scale` in fp32 and finalizes out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); the backward recomputes
// P = exp(q.k * scale - lse), zeroed where masked (k >= s_k, q >= s_q, or
// above the causal diagonal k > q), and dS = P * (dP - delta).
//
// What bounds them: operations.  At the training shape (s 2048, d 128) each
// 64x64 tile pair does 2 * 64 * 64 * 128 flops per product over 32 KB of
// bf16 K/V, far above the ~295 flop/byte where an H100 turns compute-bound.
//
// Design (simple and right first):
// * one thread block of 256 threads per (batch*head, 64-row tile): a q tile
//   for the forward and dq, a k tile for dk/dv.  The TPU's sequential grid
//   axis becomes a loop inside the block over the other side's 64-row tiles;
//   causal loops stop at the diagonal (forward, dq) or start at it (dk/dv),
//   so dead tiles are never loaded.  The forward and dq launch their q tiles
//   last-first, so the longest causal loops start first;
// * each tile is staged in shared memory as fp32 rows padded to d+4 floats
//   (rows beyond the sequence are zero); the products are fp32 FMAs on
//   the CUDA cores, each thread holding a 4x4 piece of the 64x64 score tile
//   (rows ty+16i, columns tx+16j) and a 4 x d/16 piece of the accumulators;
// * the online-softmax row max and sum reduce over the 16 lanes of a row with
//   warp shuffles; P (or dS) goes through shared memory for the next product;
// * dq and dk/dv are separate kernels that each own their output tile, so
//   there are no atomics and the results are deterministic.
// Later work, not done here: dq on the tensor cores with dS split into bf16
// hi + lo as flash_attention_sm90.cu does, and cp.async double buffering.
//
// Plain C interface, bound through ctypes: each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success).
// dtype 0 is float32, 1 is bfloat16 (dq only); d is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // floats of padding per shared row
constexpr int kLdS = kTile + kPad;
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

struct Strides {
  long long b, s, h;  // element strides of a (batch, seq, heads, d) tensor
};

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [row0, row0 + 64) of head `head` of batch `batch` into dst[64][D+4]
// as fp32 times `mul`; rows at or past `n` become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int batch, int head,
                                          int row0, int n, float mul) {
  constexpr int kLd = D + kPad;
  constexpr int kPerRow = D / 8;
  const T* base = src + batch * st.b + head * st.h;
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 8;
    float v[8];
    if (row0 + r < n) {
      load8(base + static_cast<long long>(row0 + r) * st.s + col, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    float* d = dst + r * kLd + col;
    store4(d, v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
    store4(d + 4, v[4] * mul, v[5] * mul, v[6] * mul, v[7] * mul);
  }
}

// c[i][j] = sum_k A[ty + 16i][k] * B[tx + 16j][k]; A, B are [64][D+4].
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float (&c)[4][4]) {
  constexpr int kLd = D + kPad;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kLd + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kLd + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = c[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        c[i][j] = s;
      }
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][4v + e] += sum_j P[ty + 16i][j] * X[j][tx*4 + 64v + e]; P is
// [64][68], X is [64][D+4].
template <int D>
__device__ __forceinline__ void mm_acc(const float* P, const float* X,
                                       float (&acc)[4][D / 16]) {
  constexpr int kLd = D + kPad;
  constexpr int kVec = D / 64;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kLdS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float4 x = *reinterpret_cast<const float4*>(
            X + (j + jj) * kLd + tx * 4 + 64 * v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = lane(p[i], jj);
          acc[i][4 * v + 0] = fmaf(pv, x.x, acc[i][4 * v + 0]);
          acc[i][4 * v + 1] = fmaf(pv, x.y, acc[i][4 * v + 1]);
          acc[i][4 * v + 2] = fmaf(pv, x.z, acc[i][4 * v + 2]);
          acc[i][4 * v + 3] = fmaf(pv, x.w, acc[i][4 * v + 3]);
        }
      }
  }
}

// Reductions over the 16 lanes that hold one score row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Store rows ty + 16i of a 64 x D accumulator tile (times `mul`) into rows
// [row0, row0 + 64) of `dst`, skipping rows at or past `n`.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, Strides st, int batch,
                                           int head, int row0, int n,
                                           const float (&acc)[4][D / 16],
                                           float mul) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  T* base = dst + batch * st.b + head * st.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int v = 0; v < D / 64; ++v)
      store4(base + static_cast<long long>(r) * st.s + tx * 4 + 64 * v,
             acc[i][4 * v] * mul, acc[i][4 * v + 1] * mul,
             acc[i][4 * v + 2] * mul, acc[i][4 * v + 3] * mul);
  }
}

// The fp32 forward: one block per (q tile, batch*head).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int heads, int s_q, int s_k,
                     float scale, int causal) {
  constexpr int kLd = D + kPad;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sP = sV + kTile * kLd;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_q = (s_q + kTile - 1) / kTile;
  const int first_q = (n_q - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int batch = bh / heads;
  const int head = bh % heads;

  load_tile<float, D>(sQ, q, sq, batch, head, first_q, s_q, scale);
  int n_k = (s_k + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, (first_q + kTile - 1) / kTile + 1);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int first_k = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, D>(sK, k, sk, batch, head, first_k, s_k, 1.f);
    load_tile<float, D>(sV, v, sv, batch, head, first_k, s_k, 1.f);
    __syncthreads();
    float s[4][4];
    mm_nt<D>(sQ, sK, s);
    const bool masked = (causal && first_k + kTile - 1 > first_q) ||
                        first_k + kTile > s_k;
    if (masked) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = first_q + ty + 16 * i;
          const int c = first_k + tx + 16 * j;
          if (c >= s_k || (causal && c > r)) s[i][j] = kNegInf;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mb = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max(mb));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * kLdS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    mm_acc<D>(sP, sV, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = acc[i][e] / den;
    const int r = first_q + ty + 16 * i;
    if (tx == 0 && r < s_q)
      lse[static_cast<long long>(bh) * s_q + r] = m[i] + logf(den);
  }
  store_tile<float, D>(out, so, batch, head, first_q, s_q, acc, 1.f);
}

// Stage the saved lse and delta of rows [row0, row0 + 64) (0 past s_q).
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int bh, int row0, int s_q) {
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int r = row0 + t;
    const long long at = static_cast<long long>(bh) * s_q + r;
    s_lse[t] = r < s_q ? lse[at] : 0.f;
    s_delta[t] = r < s_q ? delta[at] : 0.f;
  }
}

// dq: one block per (q tile, batch*head), sweeping the live k tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int heads, int s_q, int s_k, float scale,
                        int causal) {
  constexpr int kLd = D + kPad;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * kLd;
  float* sK = sdO + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sS = sV + kTile * kLd;
  float* s_lse = sS + kTile * kLdS;
  float* s_delta = s_lse + kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_q = (s_q + kTile - 1) / kTile;
  const int first_q = (n_q - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int batch = bh / heads;
  const int head = bh % heads;

  load_tile<T, D>(sQ, q, sq, batch, head, first_q, s_q, 1.f);
  load_tile<T, D>(sdO, dout, sdo, batch, head, first_q, s_q, 1.f);
  load_rows(s_lse, s_delta, lse, delta, bh, first_q, s_q);
  int n_k = (s_k + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, (first_q + kTile - 1) / kTile + 1);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int first_k = kt * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k, sk, batch, head, first_k, s_k, 1.f);
    load_tile<T, D>(sV, v, sv, batch, head, first_k, s_k, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_nt<D>(sQ, sK, s);
    mm_nt<D>(sdO, sV, dp);
    const bool masked = (causal && first_k + kTile - 1 > first_q) ||
                        first_k + kTile > s_k || first_q + kTile > s_q;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ri = ty + 16 * i;
        float p = expf(s[i][j] * scale - s_lse[ri]);
        if (masked) {
          const int r = first_q + ri;
          const int c = first_k + tx + 16 * j;
          if (c >= s_k || r >= s_q || (causal && c > r)) p = 0.f;
        }
        sS[ri * kLdS + tx + 16 * j] = p * (dp[i][j] - s_delta[ri]);
      }
    __syncthreads();
    mm_acc<D>(sS, sK, acc);
  }
  store_tile<T, D>(dq, sdq, batch, head, first_q, s_q, acc, scale);
}

// fp32 dk/dv: one block per (k tile, batch*head), sweeping the live q
// tiles.  Scores are computed transposed (rows are keys, columns queries).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdk, Strides sdv,
                         int heads, int s_q, int s_k, float scale,
                         int causal) {
  constexpr int kLd = D + kPad;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * kLd;
  float* sQ = sV + kTile * kLd;
  float* sdO = sQ + kTile * kLd;
  float* sS = sdO + kTile * kLd;
  float* s_lse = sS + kTile * kLdS;
  float* s_delta = s_lse + kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int first_k = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int batch = bh / heads;
  const int head = bh % heads;

  load_tile<float, D>(sK, k, sk, batch, head, first_k, s_k, 1.f);
  load_tile<float, D>(sV, v, sv, batch, head, first_k, s_k, 1.f);
  const int n_q = (s_q + kTile - 1) / kTile;
  // first q tile with a row at or below the diagonal (equal tile sizes)
  const int q0 = causal ? first_k / kTile : 0;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      dk_acc[i][e] = 0.f;
      dv_acc[i][e] = 0.f;
    }

  for (int qt = q0; qt < n_q; ++qt) {
    const int first_q = qt * kTile;
    __syncthreads();
    load_tile<float, D>(sQ, q, sq, batch, head, first_q, s_q, 1.f);
    load_tile<float, D>(sdO, dout, sdo, batch, head, first_q, s_q, 1.f);
    load_rows(s_lse, s_delta, lse, delta, bh, first_q, s_q);
    __syncthreads();
    float st[4][4], dpt[4][4];
    mm_nt<D>(sK, sQ, st);    // st[i][j]: key ty+16i, query tx+16j
    mm_nt<D>(sV, sdO, dpt);  // dP transposed
    const bool masked = (causal && first_k + kTile - 1 > first_q) ||
                        first_k + kTile > s_k || first_q + kTile > s_q;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rj = tx + 16 * j;
        float p = expf(st[i][j] * scale - s_lse[rj]);
        if (masked) {
          const int r = first_q + rj;
          const int c = first_k + ty + 16 * i;
          if (c >= s_k || r >= s_q || (causal && c > r)) p = 0.f;
        }
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - s_delta[rj]);
        sS[(ty + 16 * i) * kLdS + rj] = p;
      }
    __syncthreads();
    mm_acc<D>(sS, sdO, dv_acc);  // dv += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sS[(ty + 16 * i) * kLdS + tx + 16 * j] = dpt[i][j];
    __syncthreads();
    mm_acc<D>(sS, sQ, dk_acc);  // dk += dS^T q
  }
  store_tile<float, D>(dk, sdk, batch, head, first_k, s_k, dk_acc, scale);
  store_tile<float, D>(dv, sdv, batch, head, first_k, s_k, dv_acc, 1.f);
}

constexpr int fwd_smem(int d) {
  return (3 * kTile * (d + kPad) + kTile * kLdS) * 4;
}
constexpr int bwd_smem(int d) {
  return (4 * kTile * (d + kPad) + kTile * kLdS + 2 * kTile) * 4;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        const long long* st, int batch, int heads, int s_q, int s_k,
        float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  if (int err = set_smem(kernel, fwd_smem(D))) return err;
  const dim3 grid((s_q + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, fwd_smem(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), heads, s_q, s_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const long long* st,
           int batch, int heads, int s_q, int s_k, float scale, int causal,
           cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  if (int err = set_smem(kernel, bwd_smem(D))) return err;
  const dim3 grid((s_q + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, bwd_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), heads, s_q,
      s_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const long long* st, int batch, int heads, int s_q, int s_k,
            float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D>;
  if (int err = set_smem(kernel, bwd_smem(D))) return err;
  const dim3 grid((s_k + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, bwd_smem(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), heads, s_q, s_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (dtype, d): 0 = float32, 1 = bfloat16; d 64 or 128.
#define FLASH_DISPATCH(FN, ...)                                   \
  switch (dtype * 1000 + d) {                                     \
    case 64: return FN<float, 64>(__VA_ARGS__);                   \
    case 128: return FN<float, 128>(__VA_ARGS__);                 \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);        \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

// fp32 only (dtype 0): bf16 K2 and K4 are in flash_attention_sm90.cu.
#define FLASH_DISPATCH_F32(FN, ...)                               \
  switch (dtype * 1000 + d) {                                     \
    case 64: return FN<64>(__VA_ARGS__);                          \
    case 128: return FN<128>(__VA_ARGS__);                        \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

}  // namespace

extern "C" {

// strides: 4 x (b, s, h) element strides for q, k, v, out.
int flash_attention_fwd(int dtype, int d, const void* q, const void* k,
                        const void* v, void* out, void* lse,
                        const long long* strides, int batch, int heads,
                        int s_q, int s_k, float scale, int causal,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_F32(fwd, q, k, v, out, lse, strides, batch, heads, s_q,
                     s_k, scale, causal, s)
}

// strides: 5 x (b, s, h) for q, k, v, dout, dq.
int flash_attention_bwd_dq(int dtype, int d, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* delta, void* dq,
                           const long long* strides, int batch, int heads,
                           int s_q, int s_k, float scale, int causal,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, strides, batch,
                 heads, s_q, s_k, scale, causal, s)
}

// strides: 6 x (b, s, h) for q, k, v, dout, dk, dv.
int flash_attention_bwd_dkv(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            const long long* strides, int batch, int heads,
                            int s_q, int s_k, float scale, int causal,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_F32(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, strides,
                     batch, heads, s_q, s_k, scale, causal, s)
}

// Dynamic shared memory a block of the fp32 forward (kernel 0) or of dq
// and the fp32 dk/dv (1) takes at head dim d (ptxas -v does not count it).
int flash_attention_smem_bytes(int kernel, int d) {
  return kernel == 0 ? fwd_smem(d) : bwd_smem(d);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
