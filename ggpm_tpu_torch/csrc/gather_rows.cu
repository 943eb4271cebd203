// Row gather for Hopper (sm_90a):
//
//     out[r, :] = src[idx[r], :]        for r < n
//
// src is f32 [M, W], idx int32 [n] (an [N, A] index table read flat), out
// f32 [n, W].  It is the forward of the message-passing depth loop's
// gather of [h | h Kf | c] by bgraph (W = 3H = 750 at the canonical
// width), `gather_nd_t` in ggpm_tpu/ops/graph_ops.py, which the JAX package
// left to XLA's gather (no Pallas kernel); its backward is nei_sum.cu's
// transpose over the same table.
//
// What bounds it on an H100: bytes, and the latency of the two dependent
// loads (index, then row).  Each output row belongs to `tpr` threads
// (threadIdx.x) of a block that holds `rpb` rows (threadIdx.y); each thread
// copies column chunks of V = float, float2 or float4, the widest the
// alignment allows (a 3,000-byte row allows float2, not float4).  Every
// thread of a row loads the row's index itself (one L1 line for the
// block), so no shuffle or barrier is needed.  Stores are ordinary: the
// depth round reads the gathered tensor right away, so it should stay in
// the L2.  The launch plan (V, tpr, rpb, grid) is chosen by `plan` in
// ops/gather_rows.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block; ops/gather_rows.py agrees

template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows_kernel(const float* __restrict__ srcf, const int32_t* __restrict__ idx,
                   float* __restrict__ outf, int64_t n, int64_t cols) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const V* from = reinterpret_cast<const V*>(srcf) +
                  static_cast<int64_t>(__ldg(idx + row)) * cols;
  V* to = reinterpret_cast<V*>(outf) + row * cols;
  for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) to[c] = __ldg(from + c);
}

using Kernel = void (*)(const float*, const int32_t*, float*, int64_t, int64_t);

Kernel pick(int vec) {
  switch (vec) {
    case 1: return gather_rows_kernel<float>;
    case 2: return gather_rows_kernel<float2>;
    case 4: return gather_rows_kernel<float4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the plan on `stream` and returns the launch's error, else
// cudaGetLastError() (0 on success).  cols = W / vec.
int ggpm_gather_rows_f32(const float* src, const int32_t* idx, float* out,
                         int64_t n, int64_t cols, int vec, int tpr, int rpb,
                         int64_t grid, void* stream) {
  Kernel k = pick(vec);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&src, &idx, &out, &n, &cols};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(k), dim3(static_cast<unsigned>(grid)),
      dim3(tpr, rpb), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
