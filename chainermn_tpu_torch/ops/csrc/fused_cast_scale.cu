// Fused cast and scale for Hopper, sm_90a: y = (float(x) * scale) -> Out.
//
// Replaces the TPU kernel `_cast_scale_kernel`
// (chainermn_tpu/ops/pallas_attention.py:1463, launched by `fused_cast_scale`
// at :1490), itself the counterpart of the cast/scale ElementwiseKernels that
// ChainerMN's PureNcclCommunicator launches around its reduced-precision
// all-reduce.  It computes the same function, not the same blocks: every
// element is widened to fp32, multiplied by the fp32 `scale`, and rounded
// once to the output type with round-to-nearest-even (`__float2bfloat16_rn`,
// `__float2half_rn`), so fp16 overflow gives +-inf and NaN stays NaN, as
// `Tensor.to` does.  The TPU's 128-lane x 8-sublane padding and 512-row
// blocks are not carried over: the kernel walks the flat buffer as it is.
//
// What bounds it: bytes.  One multiply per element against 6-8 bytes read
// and written, far below the ~20 flop/byte where an H100's fp32 CUDA cores
// would be the limit.
//
// Design (simple and right first): one grid-stride loop over VEC-element
// vectors (16 bytes on the narrower side: 4 elements when both sides are
// fp32, else 8), loaded and stored as whole vectors where both pointers sit
// at the same phase of a vector; the elements before the first whole vector
// (a bucket's view may start at any element offset) and after the last one
// go through a scalar loop in the same kernel.  When the two pointers have
// different phases the whole buffer takes the scalar loop.
//
// Plain C interface, bound through ctypes: fused_cast_scale launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (0 on
// success).  Type codes: 0 fp32, 1 bf16, 2 fp16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each SM

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// N elements moved as one aligned unit (16 or 32 bytes: one or two 16-byte
// loads/stores)
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename In, typename Out, int VEC>
__global__ void __launch_bounds__(kThreads)
    fused_cast_scale_kernel(const In* __restrict__ x, Out* __restrict__ y,
                            long long n, long long head, long long n_vec,
                            float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  // the aligned body: elements [head, head + n_vec * VEC)
  const Vec<In, VEC>* xv = reinterpret_cast<const Vec<In, VEC>*>(x + head);
  Vec<Out, VEC>* yv = reinterpret_cast<Vec<Out, VEC>*>(y + head);
  for (long long i = tid; i < n_vec; i += stride) {
    const Vec<In, VEC> a = xv[i];
    Vec<Out, VEC> b;
#pragma unroll
    for (int e = 0; e < VEC; ++e) b.v[e] = from_float<Out>(to_float(a.v[e]) * scale);
    yv[i] = b;
  }

  // the scalar head [0, head) and tail [head + n_vec * VEC, n)
  const long long tail = head + n_vec * VEC;
  const long long n_scalar = head + (n - tail);
  for (long long i = tid; i < n_scalar; i += stride) {
    const long long j = i < head ? i : tail + (i - head);
    y[j] = from_float<Out>(to_float(x[j]) * scale);
  }
}

template <typename In, typename Out>
int launch(const void* x, void* y, long long n, float scale, void* stream) {
  constexpr int VEC = (sizeof(In) == 4 && sizeof(Out) == 4) ? 4 : 8;
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ay = reinterpret_cast<uintptr_t>(y);
  // each pointer's position inside a VEC-element vector, in elements
  const long long phase_x = static_cast<long long>((ax / sizeof(In)) % VEC);
  const long long phase_y = static_cast<long long>((ay / sizeof(Out)) % VEC);
  long long head = n;
  long long n_vec = 0;
  if (ax % sizeof(In) == 0 && ay % sizeof(Out) == 0 && phase_x == phase_y) {
    head = (VEC - phase_x) % VEC;
    if (head > n) head = n;
    n_vec = (n - head) / VEC;
  }
  const long long work = n_vec > n - n_vec * VEC ? n_vec : n - n_vec * VEC;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  fused_cast_scale_kernel<In, Out, VEC>
      <<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const In*>(x), static_cast<Out*>(y), n, head, n_vec, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_to(int out_code, const void* x, void* y, long long n, float scale,
              void* stream) {
  switch (out_code) {
    case 0:
      return launch<In, float>(x, y, n, scale, stream);
    case 1:
      return launch<In, __nv_bfloat16>(x, y, n, scale, stream);
    case 2:
      return launch<In, __half>(x, y, n, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int fused_cast_scale(const void* x, void* y, long long n, int in_code,
                     int out_code, float scale, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_code) {
    case 0:
      return launch_to<float>(out_code, x, y, n, scale, stream);
    case 1:
      return launch_to<__nv_bfloat16>(out_code, x, y, n, scale, stream);
    case 2:
      return launch_to<__half>(out_code, x, y, n, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_cast_scale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
