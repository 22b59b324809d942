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
// turns compute-bound.
//
// Design (simple and right first):
// * one thread block per (slot, head): grid (heads, batch).  The TPU's
//   sequential page grid axis becomes a loop inside the block;
// * each of the block's 8 warps takes every 8th cache position, looking its
//   page up in the block table; each lane holds d/32 consecutive elements of
//   q, of the K and V rows and of the accumulator, loaded with the widest
//   aligned vector loads, so a warp reads one K row and one V row coalesced;
// * the q.k dot product is a warp-shuffle reduction; each warp keeps its own
//   fp32 online-softmax state (m, l, acc) in registers;
// * at the end the warps' states merge through shared memory.
// Later work, not done here: split-K over pages (flash-decoding) to occupy
// more than batch*heads SMs, and cp.async/TMA staging of the next pages.
//
// Plain C interface, bound through ctypes: flash_decode_bf16 and
// flash_decode_f32 launch on the given stream, allocate nothing, and return
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// EPL consecutive elements at `src` into fp32 registers, with vector loads
// (src must be aligned to min(16, EPL * sizeof(T)) bytes).
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         float (&dst)[EPL]) {
  constexpr int kBytes = EPL * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[c * kPer + i] = to_float(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < EPL; ++i) dst[i] = to_float(e[i]);
  } else if constexpr (kBytes == 4) {
    const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < EPL; ++i) dst[i] = to_float(e[i]);
  } else {
    dst[0] = to_float(src[0]);
  }
}

// q, out: (batch, heads, D); k_pages, v_pages: (num_pages, page_size, heads,
// D); block_tables: (batch, pages_per_slot) int32; lengths: (batch,) int32.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int heads, int page_size, int pages_per_slot,
                        float scale) {
  constexpr int EPL = D / 32;
  const int head = blockIdx.x;
  const int slot = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(slot) * heads + head;
  T* o = out + row * D;

  // positions past the table width are never live (the TPU grid stops at
  // pages_per_slot)
  const int length = min(lengths[slot], pages_per_slot * page_size);
  if (length <= 0) {
    for (int e = threadIdx.x; e < D; e += blockDim.x) store(o + e, 0.f);
    return;
  }

  float qv[EPL];
  load_row<T, EPL>(q + row * D + lane * EPL, qv);
#pragma unroll
  for (int i = 0; i < EPL; ++i) qv[i] *= scale;

  float m = kNegInf;
  float l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  const int* table = block_tables + static_cast<long long>(slot) * pages_per_slot;
  const long long pos_stride = static_cast<long long>(heads) * D;
  const long long lane_off = static_cast<long long>(head) * D + lane * EPL;
  for (int pos = warp; pos < length; pos += kWarps) {
    const int page = __ldg(table + pos / page_size);
    const long long at =
        (static_cast<long long>(page) * page_size + pos % page_size) * pos_stride +
        lane_off;
    float kr[EPL], vr[EPL];
    load_row<T, EPL>(k_pages + at, kr);
    load_row<T, EPL>(v_pages + at, vr);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) s += qv[i] * kr[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] = acc[i] * alpha + p * vr[i];
    m = m_new;
  }

  // merge the warps' online-softmax states
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][D];
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) s_acc[warp][lane * EPL + i] = acc[i];
  __syncthreads();

  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
  float w_scale[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    w_scale[w] = expf(s_m[w] - m_all);  // 0 for a warp that saw no position
    l_all += s_l[w] * w_scale[w];
  }
  const float inv = 1.f / fmaxf(l_all, 1e-30f);
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_acc[w][e] * w_scale[w];
    store(o + e, sum * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, int batch,
           int heads, int d, int page_size, int pages_per_slot, float scale,
           void* stream) {
  const dim3 grid(heads, batch);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  switch (d) {
    case 32:
      flash_decode_kernel<T, 32><<<grid, block, 0, s>>>(
          qp, kp, vp, bt, ln, op, heads, page_size, pages_per_slot, scale);
      break;
    case 64:
      flash_decode_kernel<T, 64><<<grid, block, 0, s>>>(
          qp, kp, vp, bt, ln, op, heads, page_size, pages_per_slot, scale);
      break;
    case 128:
      flash_decode_kernel<T, 128><<<grid, block, 0, s>>>(
          qp, kp, vp, bt, ln, op, heads, page_size, pages_per_slot, scale);
      break;
    case 256:
      flash_decode_kernel<T, 256><<<grid, block, 0, s>>>(
          qp, kp, vp, bt, ln, op, heads, page_size, pages_per_slot, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_decode_bf16(const void* q, const void* k_pages, const void* v_pages,
                      const void* block_tables, const void* lengths, void* out,
                      int batch, int heads, int d, int page_size,
                      int pages_per_slot, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths, out,
                               batch, heads, d, page_size, pages_per_slot,
                               scale, stream);
}

int flash_decode_f32(const void* q, const void* k_pages, const void* v_pages,
                     const void* block_tables, const void* lengths, void* out,
                     int batch, int heads, int d, int page_size,
                     int pages_per_slot, float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, batch,
                       heads, d, page_size, pages_per_slot, scale, stream);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
