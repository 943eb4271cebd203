// Neighbour gather-sum for Hopper (sm_90a):
//
//     out[n, :] = sum_{a < A} h[graph[n, a], :]
//
// h is f32 [M, H], graph int32 [N, A], out f32 [N, H].  Row 0 of h is the
// zero padding row, so padded slots of graph (index 0) add nothing and need
// no mask.
//
// Replaces the Pallas TPU kernel `_kernel` of ggpm_tpu/ops/pallas_gather.py
// (launched by `_nei_sum_pallas_impl`, wrapped by `nei_sum_pallas`), which
// serves the message-passing readouts of ggpm_tpu/models/encoder.py.  That
// kernel walks its grid in order on one core, DMAs one 8-row block of h per
// neighbour into a VMEM accumulator, and carries the sum across steps.  Here
// blocks run in parallel in no order, so nothing is carried: each warp owns
// one output row.  The block first loads its rows' A indices into shared
// memory once; then each lane strides over the H columns, adds the A
// neighbour values in the fixed order a = 0..A-1 in fp32 registers, and
// writes its columns once.
//
// Loads are as wide as the row alignment allows (the wrapper picks VEC): at
// H = 250 a row is 1,000 bytes, which is 8-byte but not 16-byte aligned, so
// rows are read as float2; float4 only when H % 4 == 0 and the pointers are
// 16-byte aligned; scalars otherwise.
//
// Bound: the work moves about (M*H + N*A + N*H) * 4 bytes and does N*A*H
// adds, so it is bound by memory: at 3.35 TB/s, a few MB take a few
// microseconds.  At the serve shapes that is less than the cost of a launch,
// and this first design does nothing about it (no fusion with the
// surrounding matmul, no persistent blocks).
//
// Precondition, checked by the wrapper: graph and h are contiguous, every
// index lies in [0, M), and A * kRowsPerBlock * 4 bytes fit in 48 KB of
// shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per output row
constexpr int kThreads = kRowsPerBlock * 32;

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add_to(float2& acc, float2 v) {
  acc.x += v.x;
  acc.y += v.y;
}
__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V is float, float2 or float4; cols = H / (sizeof(V) / 4).
template <typename V>
__global__ void __launch_bounds__(kThreads)
nei_sum_kernel(const V* __restrict__ h, const int32_t* __restrict__ graph,
               V* __restrict__ out, int64_t n, int a, int64_t cols) {
  extern __shared__ int32_t rows[];  // [kRowsPerBlock, a]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t left = n - row0;
  const int nrows = left < kRowsPerBlock ? static_cast<int>(left) : kRowsPerBlock;

  for (int i = threadIdx.x; i < nrows * a; i += kThreads) {
    rows[i] = graph[row0 * a + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= nrows) return;  // ragged last block
  const int32_t* idx = rows + warp * a;
  V* dst = out + (row0 + warp) * cols;
  for (int64_t c = lane; c < cols; c += 32) {
    V acc = zero<V>();
#pragma unroll 4
    for (int j = 0; j < a; ++j) {
      add_to(acc, __ldg(h + static_cast<int64_t>(idx[j]) * cols + c));
    }
    dst[c] = acc;
  }
}

template <typename V>
cudaError_t launch(const float* h, const int32_t* graph, float* out, int64_t n,
                   int a, int64_t hdim, cudaStream_t stream) {
  const int64_t cols = hdim / (sizeof(V) / sizeof(float));
  const unsigned blocks = static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = sizeof(int32_t) * kRowsPerBlock * a;
  nei_sum_kernel<V><<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const V*>(h), graph, reinterpret_cast<V*>(out), n, a, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The row count the wrapper's shared-memory check uses.
int ggpm_nei_sum_rows_per_block() { return kRowsPerBlock; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// vec is 1, 2 or 4: the float width of each load and store.
int ggpm_nei_sum_f32(const float* h, const int32_t* graph, float* out,
                     int64_t n, int64_t a, int64_t hdim, int vec, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int ai = static_cast<int>(a);
  switch (vec) {
    case 4: return launch<float4>(h, graph, out, n, ai, hdim, s);
    case 2: return launch<float2>(h, graph, out, n, ai, hdim, s);
    case 1: return launch<float>(h, graph, out, n, ai, hdim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
