// Paged single-token decode attention (flash decode) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_flash_decode_kernel`
// (chainermn_tpu/ops/pallas_attention.py:1271, launched by `_flash_decode`
// at :1353).  It computes the same function, not the same blocks: each
// decode slot's one query row attends, per head, over the cache positions
// [0, length) that the slot's block table names, with an fp32 online
// softmax.  Positions at or past `length` are never read, so pages past the
// length cost nothing; a length-0 (padded) slot writes zeros; the result is
// acc / max(l, 1e-30), cast to the query's type.
//
// What bounds it: the bytes of the live K/V pages.  A decode step does
// 4 * length * d flops per (slot, head) over 4 * length * d bytes of bf16
// K/V, about 1 flop per byte, far below the ~295 flop/byte where an H100
// turns compute-bound.  So the card has to keep many loads in flight on
// every SM.
//
// Design (split-K, "flash-decoding"):
// * one block of 128 threads per (split, head, slot).  The wrapper picks
//   the number of splits from the batch, the heads and the SM count (at
//   least two blocks an SM; it never reads `lengths`, which would
//   synchronize).  On the device each slot's live pages are dealt out to
//   the splits in whole pages, ceil(pages / splits) each; splits left
//   without a page return at once;
// * inside a block each row of K and V is shared by kLanes consecutive
//   threads (16 bytes each, or d / 32 elements when a row is longer than
//   512 bytes), so a block stages kGroups = 128 / kLanes rows at a time.  A
//   chunk of 8 KB of K and V rows goes global -> shared with 16-byte
//   cp.async into a ring of kStages = 4 stages, three chunks in flight
//   while one is computed.  A thread reads back only the pieces it copied,
//   so the loop needs no barrier;
// * per chunk a thread dots its rows with its piece of q (pre-scaled by
//   scale * log2 e), sums over its kLanes lanes with shuffles, and updates
//   an online softmax (m, l, acc) of its row group with one max, one
//   rescale and one exp2 per row: a chunk costs one dependent step, not
//   one per position.  At the end the row groups merge through shared
//   memory;
// * the merge across splits: a slot's one live split writes the output;
//   otherwise each split writes (acc, m, l) to the workspace and bumps the
//   (slot, head)'s counter, and the last block to arrive combines the
//   splits in split order (bit-identical from run to run) and resets the
//   counter to 0 for the next launch.  One launch, no atomics on data.
//
// Plain C interface, bound through ctypes: flash_decode_bf16 and
// flash_decode_f32 launch on the given stream, allocate nothing (the
// wrapper passes the workspace, batch * heads * splits * (d + 2) floats,
// and the counters, batch * heads ints that are 0 at the first launch),
// and return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;            // depth of the copy ring
constexpr int kStageBytes = 8192;     // K and V rows of one chunk
constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive elements at `src` (16-byte aligned, N * sizeof(T) a
// multiple of 16) into fp32 registers; global memory through the read-only
// path, shared memory with plain loads.
template <typename T, int N, bool kGlobal>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         float (&dst)[N]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    uint4 raw;
    if constexpr (kGlobal) {
      raw = __ldg(reinterpret_cast<const uint4*>(src) + c);
    } else {
      raw = reinterpret_cast<const uint4*>(src)[c];
    }
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[c * kPer + i] = to_float(e[i]);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How a block of T at head dim D cuts its rows.
template <typename T, int D>
struct Geometry {
  static constexpr int kBytes = static_cast<int>(sizeof(T));
  // elements of a row a thread holds: 16 bytes, or D / 32 for long rows
  static constexpr int kElems = 16 / kBytes > D / 32 ? 16 / kBytes : D / 32;
  static constexpr int kLanes = D / kElems;           // threads a row
  static constexpr int kGroups = kThreads / kLanes;   // rows a pass
  static constexpr int kPieces = kElems * kBytes / 16;  // copies a row
  // rows a thread takes in a chunk, and the chunk in positions
  static constexpr int kRows = kStageBytes / (2 * kThreads * kElems * kBytes);
  static constexpr int kChunk = kGroups * kRows;
  static_assert(kLanes <= 32 && kRows >= 1, "a row within one warp");
};

// q, out: (batch, heads, D); k_pages, v_pages: (num_pages, page_size,
// heads, D); block_tables: (batch, pages_per_slot) int32; lengths: (batch,)
// int32; work: (batch * heads * splits, D + 2) fp32; counters: (batch *
// heads,) int32.  Grid (splits, heads, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ work, int* __restrict__ counters,
                        int heads, int page_size, int pages_per_slot,
                        float scale) {
  using G = Geometry<T, D>;
  constexpr int E = G::kElems;
  __shared__ __align__(16) uint8_t smem[kStages * kStageBytes];
  __shared__ float s_m[G::kGroups], s_l[G::kGroups];
  __shared__ int s_last;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int head = blockIdx.y;
  const int slot = blockIdx.z;
  const long long bh = static_cast<long long>(slot) * heads + head;
  T* o = out + bh * D;

  // positions past the table width are never live (the TPU grid stops at
  // pages_per_slot)
  const int length = min(lengths[slot], pages_per_slot * page_size);
  const int pages = length > 0 ? (length + page_size - 1) / page_size : 0;
  if (pages == 0) {
    if (split == 0)
      for (int e = threadIdx.x; e < D; e += kThreads) store(o + e, 0.f);
    return;
  }
  const int per = (pages + splits - 1) / splits;  // pages a split
  const int live = (pages + per - 1) / per;       // splits with pages
  if (split >= live) return;
  const int start = split * per * page_size;
  const int end = min(start + per * page_size, length);
  const int n_chunks = (end - start + G::kChunk - 1) / G::kChunk;

  const int lane = threadIdx.x % G::kLanes;  // which piece of a row
  const int group = threadIdx.x / G::kLanes;
  const int col = lane * E;
  const int* table = block_tables + static_cast<long long>(slot) * pages_per_slot;
  const long long pos_stride = static_cast<long long>(heads) * D;
  const T* k_head = k_pages + static_cast<long long>(head) * D + col;
  const T* v_head = v_pages + static_cast<long long>(head) * D + col;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const T* ring_t = reinterpret_cast<const T*>(smem);
  constexpr int kRowsB = G::kChunk * D * G::kBytes;  // K rows of a stage

  // chunk c's rows of this thread into stage c % kStages; rows past `end`
  // are zero-filled and their pages never read
  auto copy_chunk = [&](int c) {
    const uint32_t stage = ring + (c % kStages) * kStageBytes;
#pragma unroll
    for (int r = 0; r < G::kRows; ++r) {
      const int row = group + G::kGroups * r;
      const int pos = start + c * G::kChunk + row;
      const bool ok = pos < end;
      long long at = 0;
      if (ok) {
        const int page = __ldg(table + pos / page_size);
        at = (static_cast<long long>(page) * page_size + pos % page_size) *
             pos_stride;
      }
      const uint32_t dst = stage + (row * D + col) * G::kBytes;
#pragma unroll
      for (int pc = 0; pc < G::kPieces; ++pc) {
        cp_async16(dst + 16 * pc, k_head + at + pc * (16 / G::kBytes), ok);
        cp_async16(dst + kRowsB + 16 * pc, v_head + at + pc * (16 / G::kBytes),
                   ok);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) copy_chunk(c);
    cp_async_commit();
  }

  float qv[E];
  load_row<T, E, true>(q + bh * D + col, qv);
  const float scale2 = scale * kLog2e;  // scores in log2 units
#pragma unroll
  for (int i = 0; i < E; ++i) qv[i] *= scale2;

  float m = kNegInf;  // the row group's running max (log2 units)
  float l = 0.f;      // and sum
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    if (c + kStages - 1 < n_chunks) copy_chunk(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk c has landed
    const T* stage = ring_t + (c % kStages) * (kStageBytes / G::kBytes);

    float sc[G::kRows];
    float m_new = m;
#pragma unroll
    for (int r = 0; r < G::kRows; ++r) {
      const int row = group + G::kGroups * r;
      float kr[E];
      load_row<T, E, false>(stage + row * D + col, kr);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) s = fmaf(qv[i], kr[i], s);
#pragma unroll
      for (int off = G::kLanes / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const bool ok = start + c * G::kChunk + row < end;
      sc[r] = ok ? s : kNegInf;
      m_new = fmaxf(m_new, sc[r]);
    }
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < G::kRows; ++r) {
      const int row = group + G::kGroups * r;
      const bool ok = start + c * G::kChunk + row < end;
      const float p = ok ? exp2f(sc[r] - m_new) : 0.f;
      float vr[E];
      load_row<T, E, false>(stage + G::kChunk * D + row * D + col, vr);
      l += p;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
    }
    m = m_new;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the row groups' states

  // merge the row groups: a group that saw no live position has m = -1e30
  // and weight 0
  float* s_acc = reinterpret_cast<float*>(smem);  // [kGroups][D]
#pragma unroll
  for (int i = 0; i < E; ++i) s_acc[group * D + col + i] = acc[i];
  if (lane == 0) {
    s_m[group] = m;
    s_l[group] = l;
  }
  __syncthreads();
  float m_blk = kNegInf;
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) m_blk = fmaxf(m_blk, s_m[g]);
  float l_blk = 0.f;
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) l_blk += exp2f(s_m[g] - m_blk) * s_l[g];
  float part[(D + kThreads - 1) / kThreads];
#pragma unroll
  for (int j = 0; j < (D + kThreads - 1) / kThreads; ++j) {
    const int d = threadIdx.x + kThreads * j;
    float sum = 0.f;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g)
        sum += exp2f(s_m[g] - m_blk) * s_acc[g * D + d];
    }
    part[j] = sum;
  }

  if (live == 1) {
    const float inv = 1.f / fmaxf(l_blk, 1e-30f);
#pragma unroll
    for (int j = 0; j < (D + kThreads - 1) / kThreads; ++j) {
      const int d = threadIdx.x + kThreads * j;
      if (d < D) store(o + d, part[j] * inv);
    }
    return;
  }

  // this split's (acc, m, l) to the workspace; the last split to arrive
  // merges them all
  float* mine = work + (bh * splits + split) * (D + 2);
#pragma unroll
  for (int j = 0; j < (D + kThreads - 1) / kThreads; ++j) {
    const int d = threadIdx.x + kThreads * j;
    if (d < D) mine[d] = part[j];
  }
  if (threadIdx.x == 0) {
    mine[D] = m_blk;
    mine[D + 1] = l_blk;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counters + bh, 1) == live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = work + bh * splits * (D + 2);
  float m_all = kNegInf;
  for (int s = 0; s < live; ++s) m_all = fmaxf(m_all, __ldcg(all + s * (D + 2) + D));
  float l_all = 0.f;
  for (int s = 0; s < live; ++s)
    l_all += exp2f(__ldcg(all + s * (D + 2) + D) - m_all) *
             __ldcg(all + s * (D + 2) + D + 1);
  const float inv = 1.f / fmaxf(l_all, 1e-30f);
#pragma unroll
  for (int j = 0; j < (D + kThreads - 1) / kThreads; ++j) {
    const int d = threadIdx.x + kThreads * j;
    if (d >= D) continue;
    float sum = 0.f;
    for (int s = 0; s < live; ++s)
      sum += exp2f(__ldcg(all + s * (D + 2) + D) - m_all) *
             __ldcg(all + s * (D + 2) + d);
    store(o + d, sum * inv);
  }
  if (threadIdx.x == 0) counters[bh] = 0;  // ready for the next launch
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out,
           void* work, void* counters, int batch, int heads, int d,
           int page_size, int pages_per_slot, int splits, float scale,
           void* stream) {
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(splits, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  float* wp = static_cast<float*>(work);
  int* cp = static_cast<int*>(counters);
  switch (d) {
#define FLASH_DECODE_CASE(D)                                               \
  case D:                                                                  \
    flash_decode_kernel<T, D><<<grid, kThreads, 0, s>>>(                   \
        qp, kp, vp, bt, ln, op, wp, cp, heads, page_size, pages_per_slot,  \
        scale);                                                            \
    break;
    FLASH_DECODE_CASE(32)
    FLASH_DECODE_CASE(64)
    FLASH_DECODE_CASE(128)
    FLASH_DECODE_CASE(256)
#undef FLASH_DECODE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_decode_bf16(const void* q, const void* k_pages, const void* v_pages,
                      const void* block_tables, const void* lengths, void* out,
                      void* work, void* counters, int batch, int heads, int d,
                      int page_size, int pages_per_slot, int splits,
                      float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths, out,
                               work, counters, batch, heads, d, page_size,
                               pages_per_slot, splits, scale, stream);
}

int flash_decode_f32(const void* q, const void* k_pages, const void* v_pages,
                     const void* block_tables, const void* lengths, void* out,
                     void* work, void* counters, int batch, int heads, int d,
                     int page_size, int pages_per_slot, int splits,
                     float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, work,
                       counters, batch, heads, d, page_size, pages_per_slot,
                       splits, scale, stream);
}

// Rows of K and V a block stages at a time (a chunk) and the depth of its
// copy ring, for dtype 0 (float32) or 1 (bfloat16) at head dim d; 0 for
// what the kernel does not take.
int flash_decode_chunk(int dtype, int d) {
  switch (dtype * 1000 + d) {
    case 32: return Geometry<float, 32>::kChunk;
    case 64: return Geometry<float, 64>::kChunk;
    case 128: return Geometry<float, 128>::kChunk;
    case 256: return Geometry<float, 256>::kChunk;
    case 1032: return Geometry<__nv_bfloat16, 32>::kChunk;
    case 1064: return Geometry<__nv_bfloat16, 64>::kChunk;
    case 1128: return Geometry<__nv_bfloat16, 128>::kChunk;
    case 1256: return Geometry<__nv_bfloat16, 256>::kChunk;
    default: return 0;
  }
}

int flash_decode_stages() { return kStages; }

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
