// Row gather for Hopper (sm_90a):
//
//     out[r, :] = src[idx[r], :]        for r < n
//
// src [M, W] of any element type (f32 or bf16 here), idx int32 [n] (an
// [N, A] index table read flat), out [n, W] of src's type.  It is the
// forward of the message-passing depth loop's gather of [h | h Kf | c]
// (LSTM, W = 3H = 750 at the canonical width) or [h | h U_r + b_r] (GRU,
// W = 2H = 500) by bgraph, `gather_nd_t` in ggpm_tpu/ops/graph_ops.py,
// which the JAX package left to XLA's gather (no Pallas kernel); its
// backward is transpose_sum.cu over the same table.  A row is copied as
// bytes, so one kernel serves every element type: the copy reads and writes
// every byte of the rows it gathers, row 0 included (the GRU's table holds
// b_r in row 0, not zeros).
//
// What bounds it on an H100: bytes, and the latency of the two dependent
// loads (index, then row).  Each output row belongs to `tpr` threads
// (threadIdx.x) of a block that holds `rpb` rows (threadIdx.y); each thread
// copies column chunks of V = 2, 4, 8 or 16 bytes, the widest the row's
// byte width and alignment allow (an f32 row of 750 is 3,000 bytes and
// allows 8; a bf16 row of 750, 1,500 bytes, allows 4; a bf16 row of 500,
// 1,000 bytes, 8; an f32 row of 500, 2,000 bytes, 16).  Every thread of a
// row loads the row's index itself (one L1 line for the block), so no
// shuffle or barrier is needed.  Stores are ordinary: the depth round
// reads the gathered tensor right away, so it should stay in the L2.  The
// launch plan (V, tpr, rpb, grid) is chosen by `plan` in
// ops/gather_rows.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block; ops/gather_rows.py agrees

// Launches of this library's kernels that ran on the card, counted by each
// launch's first thread and read by `ggpm_device_launches`: the profiler
// can lose a kernel's record, this count misses no launch that ran.
__device__ unsigned long long g_device_launches = 0;

__device__ __forceinline__ void count_device_launch() {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |
       threadIdx.z) == 0) {
    atomicAdd(&g_device_launches, 1ull);
  }
}

template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows_kernel(const void* __restrict__ srcv, const int32_t* __restrict__ idx,
                   void* __restrict__ outv, int64_t n, int64_t cols) {
  count_device_launch();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const V* from = reinterpret_cast<const V*>(srcv) +
                  static_cast<int64_t>(__ldg(idx + row)) * cols;
  V* to = reinterpret_cast<V*>(outv) + row * cols;
  for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) to[c] = __ldg(from + c);
}

using Kernel = void (*)(const void*, const int32_t*, void*, int64_t, int64_t);

Kernel pick(int vec_bytes) {
  switch (vec_bytes) {
    case 2: return gather_rows_kernel<unsigned short>;
    case 4: return gather_rows_kernel<unsigned int>;
    case 8: return gather_rows_kernel<uint2>;
    case 16: return gather_rows_kernel<uint4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the plan on `stream` and returns the launch's error, else
// cudaGetLastError() (0 on success).  cols = the row's bytes / vec_bytes.
int ggpm_gather_rows(const void* src, const int32_t* idx, void* out, int64_t n,
                     int64_t cols, int vec_bytes, int tpr, int rpb, int64_t grid,
                     void* stream) {
  Kernel k = pick(vec_bytes);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&src, &idx, &out, &n, &cols};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(k), dim3(static_cast<unsigned>(grid)),
      dim3(tpr, rpb), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// This library's kernel launches that ran on the current device since the
// library was loaded (`count_device_launch`), into *out; returns the copy's
// error (0 on success).
int ggpm_device_launches(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_device_launches, sizeof(*out)));
}

}  // extern "C"
