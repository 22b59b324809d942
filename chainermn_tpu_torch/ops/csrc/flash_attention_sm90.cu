// Flash attention for training on Hopper's tensor cores, sm_90a: the bf16
// forward (K2) and the bf16 dk/dv half of the FlashAttention-2 backward
// (K4).  The fp32 instantiations of both, and dq (K3) in both types, stay
// on the CUDA cores in flash_attention.cu.
//
// Replaces the TPU kernels of chainermn_tpu/ops/pallas_attention.py:
//   flash_fwd_sm90      <- `_flash_fwd_kernel` (:367, launched by
//                          `_flash_forward` at :503)
//   flash_bwd_dkv_sm90  <- `_flash_bwd_dkv_kernel` (:747, `_flash_backward`
//                          :895)
// with the C interface of flash_attention.cu: q, k, v, out and the
// gradients are bf16 (batch, seq, heads, d) read through the strides the
// wrapper passes (last dim contiguous, rows 16-byte aligned); lse and delta
// are fp32 (batch*heads, s_q); d is 64 or 128.
//
// What bounds them: operations.  At the training shape (b 8, s 2048, h 8,
// d 128, causal) the forward's two products need 0.0695 ms at the bf16
// dense peak (989 TFLOP/s) against 0.04 ms to move q, k, v and out once
// through HBM; the dk/dv kernel's four products 0.139 ms against 0.06 ms
// for its six tensors.
//
// Numerics: the TPU kernels compute P and dS in fp32, and the port is held
// to that (ops/flash_attention.py `tolerance`: 2^-13 of the output's scale,
// one bf16 ulp of each element); a P rounded once to bf16 (2^-9 relative)
// fails it (tests/test_torch_kernels_cuda.py, the negative control).  So
// the two products whose left operand is fp32 split it: hi = bf16(x),
// lo = bf16(x - hi), and X.B = hi.B + lo.B, two bf16 tensor-core products
// accumulated in fp32.  hi + lo carries 16 bits of mantissa, an error near
// 2^-17 of each element; the cost is 1.5x the products of a single-bf16
// kernel (tests/test_torch_flash_split.py emulates the split on the CPU and
// shows it inside the tolerance where single bf16 is not).  q, k, v and dO
// are bf16 already, so Q.K^T and dO.V^T are exact bf16 products.  Scores,
// the softmax, P, dP, dS and every accumulator are fp32; masked scores are
// -1e30; the forward finalizes with max(l, 1e-30).  Unlike
// flash_attention.cu, q is not pre-scaled: the scale multiplies the fp32
// scores, which moves the rounding only at the fp32 level.
//
// Design:
// * one warpgroup (128 threads) per (64-row tile, batch*head): a q tile
//   for the forward, a k tile for dk/dv; the TPU's sequential grid axis is
//   a loop over the other side's 64-row tiles.  Causal loops stop at the
//   diagonal (forward) or start from it (dk/dv), so dead tiles are never
//   loaded; the forward launches its q tiles last-first, the longest
//   causal loops first; ragged tails are masked by bounds.  dk and dv each
//   have one owner block: no atomics, deterministic results;
// * products are `wgmma.mma_async` m64nNk16, bf16 in, fp32 accumulate.
//   Forward: S = Q.K^T with Q and K from shared memory (N = 64 keys), then
//   O += P_hi.V + P_lo.V with P from registers (N = d).  dk/dv: S^T = K.Q^T
//   and dP^T = V.dO^T from shared memory, then dV += P^T_hi.dO +
//   P^T_lo.dO and dK += dS^T_hi.Q + dS^T_lo.Q with P^T and dS^T from
//   registers.  An m64n64 accumulator holds, per thread, exactly the
//   elements of the m64k16 A fragments of the next product, so P (and
//   P^T, dS^T) go from the softmax to the tensor cores without shared
//   memory; the online softmax reduces a row over the 4 lanes that share
//   it;
// * tiles are bf16 in shared memory in the 128-byte swizzle the wgmma
//   descriptors name: each 64-column slab of a 64-row tile is 64 rows of
//   128 bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8).  The
//   same layout serves as a K-major operand (Q, K, V, dO on the left of a
//   transposed product) and as an MN-major one (V, dO, Q as the right
//   operand of a P-product);
// * 16-byte cp.async copies (zero-filled past the sequence) fill a ring of
//   kStages = 2 stages: K/V tiles for the forward, Q/dO tiles with their
//   lse and delta rows for dk/dv.  The next tile's copies are in flight
//   while this tile's products run;
// * shared memory: forward 16 KB Q + 2 x 32 KB K/V at d 128 (81 KB with
//   the alignment slack), dk/dv 32 KB resident K/V + 2 x 32 KB Q/dO + rows
//   (98 KB): two blocks share an SM.  Registers: the dk/dv kernel holds
//   the dK and dV accumulators (d/2 + d/2 fp32 a thread) beside S^T and
//   dP^T (32 + 32); ptxas -v reports the count and any spill.
// Later work, not done here: a producer warp with TMA and mbarriers and
// setmaxnreg (warp specialisation), two consumer warpgroups ping-ponging
// softmax against products, persistent blocks, and K3 (dq) on the tensor
// cores.
//
// Plain C interface, bound through ctypes: each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (0 on success).
// dtype must be 1 (bfloat16); d is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // depth of the copy ring
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, s, h;  // element strides of a (batch, seq, heads, d) tensor
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- copies ---------------------------------------------------------------

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The copies this thread waited for are written by the generic proxy; the
// tensor cores read through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of one head of a (b, s, h, D) tensor (`src` at
// that batch and head, `row_stride` elements between rows) into the
// swizzled tile at `dst`; rows at or past `n` become zeros.  A thread
// copies one 16-byte column chunk of every (128 / (D / 8))-th row; that
// step is a multiple of 8 rows, so the chunk's swizzled position in its
// row is the same on every pass.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kPerRow = D / 8;                // 16-byte chunks a row
  constexpr int kRowStep = kThreads / kPerRow;  // 16 (D 64) or 8 (D 128)
  const int cc = threadIdx.x % kPerRow;
  const int r0 = threadIdx.x / kPerRow;
  dst += (cc >> 3) * 8192 + r0 * 128 + (((cc & 7) ^ (r0 & 7)) << 4);
  const bf16* from = src + static_cast<long long>(row0 + r0) * row_stride +
                     cc * 8;
#pragma unroll
  for (int i = 0; i < kTile / kRowStep; ++i) {
    const bool ok = row0 + r0 + i * kRowStep < n;
    cp_async16(dst + i * kRowStep * 128,
               ok ? from + i * kRowStep * row_stride : src, ok);
  }
}

// lse and delta of rows [row0, row0 + 64) into dst[0:64] and dst[64:128]
// (fp32), zeros past s_q.
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          long long at, int row0, int s_q) {
  const int t = threadIdx.x & (kTile - 1);
  const float* src = threadIdx.x < kTile ? lse : delta;
  const bool ok = row0 + t < s_q;
  cp_async4(dst + 4 * threadIdx.x, ok ? src + at + t : src, ok);
}

// --- wgmma ----------------------------------------------------------------

// A shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A tile as a K-major operand (its D columns are the reduction), k-step kk
// of 16 columns: 32 bytes into a 128-byte row of slab kk / 4; 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
}

// A tile as an MN-major operand (its 64 rows are the reduction, its D
// columns the output), k-step kk of 16 rows: 8-row groups 1024 bytes
// apart, 64-column slabs 8192 bytes apart.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A and B from shared memory,
// both K-major (the reduction dim contiguous); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (four bf16x2 per
// thread, the m16n8k16 A fragment of each warp's 16 rows), B from shared
// memory MN-major (the output dim contiguous, imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A from registers (four bf16x2 per
// thread, the m16n8k16 A fragment of each warp's 16 rows), B from shared
// memory MN-major (the output dim contiguous, imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// --- the hi/lo split ------------------------------------------------------

// Two fp32 values of adjacent columns as bf16x2 hi = bf16(x) and
// lo = bf16(x - hi) (x - hi is exact in fp32).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// An m64n64 fp32 accumulator as the hi and lo A fragments of four k-steps
// of 16 columns.  Accumulator element 4j + e of a thread is (row g + 8 (e/2),
// column 8j + 2t + e%2); A fragment register r of k-step kk is (row
// g + 8 (r%2), columns 16kk + 8 (r/2) + 2t and +1): the same elements.
__device__ __forceinline__ void split_frags(const float (&s)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      split2(s[e], s[e + 1], hi[kk][r], lo[kk][r]);
    }
}

// --- K2: the forward ------------------------------------------------------

// One block per (q tile, batch*head); q tiles last-first.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_sm90_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, Strides sq, Strides sk,
                          Strides sv, Strides so, int heads, int s_q, int s_k,
                          float scale, int causal) {
  extern __shared__ uint8_t smem[];
  constexpr uint32_t kTileB = kTile * D * 2;  // D / 64 slabs of 8 KB
  // swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  // ring stage st: its K tile at sQ + kTileB (1 + 2 st), its V tile next
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int n_q = (s_q + kTile - 1) / kTile;
  const int first_q = (n_q - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int batch = bh / heads;
  const int head = bh % heads;
  const bf16* qh = q + batch * sq.b + head * sq.h;
  const bf16* kh = k + batch * sk.b + head * sk.h;
  const bf16* vh = v + batch * sv.b + head * sv.h;
  int n_k = (s_k + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, first_q / kTile + 1);

  load_tile<D>(sQ, qh, sq.s, first_q, s_q);
  if (n_k > 0) {
    load_tile<D>(sQ + kTileB, kh, sk.s, 0, s_k);
    load_tile<D>(sQ + 2 * kTileB, vh, sv.s, 0, s_k);
  }
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // row max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  const float scale2 = scale * kLog2e;
  const int row = first_q + 16 * warp + g;  // this thread's rows: row, row+8

  for (int kt = 0; kt < n_k; ++kt) {
    const uint32_t sK = sQ + kTileB * (1 + 2 * (kt & 1));
    const uint32_t sV = sK + kTileB;
    if (kt + 1 < n_k) {
      const uint32_t nK = sQ + kTileB * (1 + 2 * ((kt + 1) & 1));
      load_tile<D>(nK, kh, sk.s, (kt + 1) * kTile, s_k);
      load_tile<D>(nK + kTileB, vh, sv.s, (kt + 1) * kTile, s_k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(sQ, kk), desc_kmajor(sK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int first_k = kt * kTile;
    const bool masked = (causal && first_k + kTile - 1 > first_q) ||
                        first_k + kTile > s_k;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale2;
        if (masked) {
          const int c = first_k + 8 * j + 2 * t + (e & 1);
          const int r = row + 8 * (e >> 1);
          if (c >= s_k || (causal && c > r)) x = kNegInf;
        }
        s[4 * j + e] = x;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2f(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * h + e] - m_new);
          s[4 * j + 2 * h + e] = p;
          sum += p;
        }
      l[h] = alpha * l[h] + sum;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }

    uint32_t ph[4][4], pl[4][4];
    split_frags(s, ph, pl);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(o, ph[kk], desc_mnmajor(sV, kk));
      wgmma_rs<D>(o, pl[kk], desc_mnmajor(sV, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // this stage is free for the copies of tile kt + 2
  }

  bf16* oh = out + batch * so.b + head * so.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int r = row + 8 * h;
    if (r >= s_q) continue;
    if (t == 0)
      lse[static_cast<long long>(bh) * s_q + r] = m[h] * kLn2 + logf(den);
    bf16* dst = oh + static_cast<long long>(r) * so.s + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
  }
}

// --- K4: dk and dv --------------------------------------------------------

// One block per (k tile, batch*head), sweeping the live q tiles; scores
// are computed transposed (rows are keys, columns queries).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_sm90_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              Strides sq, Strides sk, Strides sv,
                              Strides sdo, Strides sdk, Strides sdv,
                              int heads, int s_q, int s_k, float scale,
                              int causal) {
  extern __shared__ uint8_t smem[];
  constexpr uint32_t kTileB = kTile * D * 2;  // D / 64 slabs of 8 KB
  const uint32_t sK = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sV = sK + kTileB;
  // ring stage st: its Q tile at sK + kTileB (2 + 2 st), its dO tile next,
  // its lse and delta rows (64 + 64 floats) at sRows + 512 st
  const uint32_t sRows = sK + kTileB * (2 + 2 * kStages);
  const float* rows =
      reinterpret_cast<const float*>(smem + (sRows - smem_addr(smem)));
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int first_k = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int batch = bh / heads;
  const int head = bh % heads;
  const bf16* qh = q + batch * sq.b + head * sq.h;
  const bf16* kh = k + batch * sk.b + head * sk.h;
  const bf16* vh = v + batch * sv.b + head * sv.h;
  const bf16* doh = dout + batch * sdo.b + head * sdo.h;
  const long long row_at = static_cast<long long>(bh) * s_q;
  const int n_q = (s_q + kTile - 1) / kTile;
  // first q tile with a row at or below the diagonal (equal tile sizes)
  const int q0 = causal ? first_k / kTile : 0;

  load_tile<D>(sK, kh, sk.s, first_k, s_k);
  load_tile<D>(sV, vh, sv.s, first_k, s_k);
  if (q0 < n_q) {
    load_tile<D>(sK + 2 * kTileB, qh, sq.s, q0 * kTile, s_q);
    load_tile<D>(sK + 3 * kTileB, doh, sdo.s, q0 * kTile, s_q);
    load_rows(sRows, lse, delta, row_at + q0 * kTile, q0 * kTile, s_q);
  }
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const float scale2 = scale * kLog2e;
  const int key = first_k + 16 * warp + g;  // this thread's keys: key, key+8

  for (int qt = q0; qt < n_q; ++qt) {
    const int st = (qt - q0) & 1;
    const uint32_t sQ = sK + kTileB * (2 + 2 * st);
    const uint32_t sdO = sQ + kTileB;
    const float* s_lse = rows + 2 * kTile * st;
    const float* s_delta = s_lse + kTile;
    if (qt + 1 < n_q) {
      const int next = (qt + 1) * kTile;
      const uint32_t nQ = sK + kTileB * (2 + 2 * (st ^ 1));
      load_tile<D>(nQ, qh, sq.s, next, s_q);
      load_tile<D>(nQ + kTileB, doh, sdo.s, next, s_q);
      load_rows(sRows + 512 * (st ^ 1), lse, delta, row_at + next, next, s_q);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(sK, kk), desc_kmajor(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(sV, kk), desc_kmajor(sdO, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const int first_q = qt * kTile;
    const bool masked = (causal && first_k + kTile - 1 > first_q) ||
                        first_k + kTile > s_k || first_q + kTile > s_q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 lc = *reinterpret_cast<const float2*>(s_lse + c);
      const float2 dc = *reinterpret_cast<const float2*>(s_delta + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? lc.y : lc.x) * kLog2e;
        const float dlt = (e & 1) ? dc.y : dc.x;
        float p = exp2f(fmaf(s[4 * j + e], scale2, -lse2));
        if (masked) {
          const int qi = first_q + c + (e & 1);
          const int ki = key + 8 * (e >> 1);
          if (qi >= s_q || ki >= s_k || (causal && ki > qi)) p = 0.f;
        }
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dlt);
      }
    }

    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
    split_frags(s, ph, pl);
    split_frags(dp, dh, dl);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dv_acc, ph[kk], desc_mnmajor(sdO, kk));
      wgmma_rs<D>(dv_acc, pl[kk], desc_mnmajor(sdO, kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dk_acc, dh[kk], desc_mnmajor(sQ, kk));
      wgmma_rs<D>(dk_acc, dl[kk], desc_mnmajor(sQ, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // this stage is free for the copies of tile qt + 2
  }

  bf16* dkh = dk + batch * sdk.b + head * sdk.h;
  bf16* dvh = dv + batch * sdv.b + head * sdv.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key + 8 * h;
    if (r >= s_k) continue;
    bf16* dkr = dkh + static_cast<long long>(r) * sdk.s + 2 * t;
    bf16* dvr = dvh + static_cast<long long>(r) * sdv.s + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                dk_acc[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * j) = __floats2bfloat162_rn(
          dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// --- host side ------------------------------------------------------------

// Dynamic shared memory of a block, with 1024 bytes of alignment slack.
constexpr int fwd_smem(int d) {
  return 1024 + kTile * d * 2 * (1 + 2 * kStages);
}
constexpr int bwd_smem(int d) {
  return 1024 + kTile * d * 2 * (2 + 2 * kStages) + 512 * kStages;
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
  auto kernel = flash_fwd_sm90_kernel<D>;
  if (int err = set_smem(kernel, fwd_smem(D))) return err;
  const dim3 grid((s_q + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, fwd_smem(D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), heads, s_q, s_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const long long* st, int batch, int heads, int s_q, int s_k,
            float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  if (int err = set_smem(kernel, bwd_smem(D))) return err;
  const dim3 grid((s_k + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, bwd_smem(D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), heads, s_q, s_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// bf16 only (dtype 1); d 64 or 128.
#define SM90_DISPATCH(FN, ...)                                      \
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);  \
  switch (d) {                                                      \
    case 64: return FN<64>(__VA_ARGS__);                            \
    case 128: return FN<128>(__VA_ARGS__);                          \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }

}  // namespace

extern "C" {

// strides: 4 x (b, s, h) element strides for q, k, v, out.
int flash_attention_sm90_fwd(int dtype, int d, const void* q, const void* k,
                             const void* v, void* out, void* lse,
                             const long long* strides, int batch, int heads,
                             int s_q, int s_k, float scale, int causal,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SM90_DISPATCH(fwd, q, k, v, out, lse, strides, batch, heads, s_q, s_k,
                scale, causal, s)
}

// strides: 6 x (b, s, h) for q, k, v, dout, dk, dv.
int flash_attention_sm90_bwd_dkv(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int batch,
                                 int heads, int s_q, int s_k, float scale,
                                 int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SM90_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, strides, batch,
                heads, s_q, s_k, scale, causal, s)
}

// Dynamic shared memory a block of the forward (kernel 0) or of the dk/dv
// kernel (1) takes at head dim d (ptxas -v does not count it).
int flash_attention_sm90_smem_bytes(int kernel, int d) {
  return kernel == 0 ? fwd_smem(d) : bwd_smem(d);
}

// Depth of the copy ring.
int flash_attention_sm90_stages() { return kStages; }

}  // extern "C"
