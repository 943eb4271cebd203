// Neighbour gather-sum for Hopper (sm_90a):
//
//     out[n, :] = sum_{a < A} h[graph[n, a], :]
//
// h is f32 [M, H], graph int32 [N, A], out f32 [N, H].  Row 0 of h is the
// zero padding row, so padded slots of graph (index 0) add nothing and need
// no mask.  The sum runs in the fixed order a = 0..A-1 in fp32 registers.
//
// Replaces the Pallas TPU kernel `_kernel` of ggpm_tpu/ops/pallas_gather.py
// (launched by `_nei_sum_pallas_impl`, wrapped by `nei_sum_pallas`), which
// serves the message-passing readouts of ggpm_tpu/models/encoder.py.  That
// kernel walks its grid in order on one core and double-buffers one DMA of
// an aligned 8-row block of h per neighbour into a VMEM accumulator carried
// across steps.  Here blocks run in parallel in no order and nothing is
// carried: each output row belongs to `tpr` threads (threadIdx.x) of one
// block, each thread owns one column chunk of V = float, float2 or float4
// (the widest the row alignment allows), and a block holds `rpb` rows
// (threadIdx.y).  The launch plan (kind, V, A, tpr, rpb, grid) is chosen by `plan` in ops/nei_sum.py; this file checks nothing
// that the plan decided.
//
// What bounds it on an H100, and what the design does about it (PERF.md,
// section 6, has the card's times of both kinds at every case, measured by
// chip_smoke.py):
// - Latency, at the serve shapes (a few MB, which the L2 holds because the
//   depth loop just wrote h).  A warp per row walking columns and neighbours
//   in runtime loops waits through about eight dependent rounds of L2
//   latency.  So A is a template parameter (1..8, plus a generic path in
//   groups of 8); lane j of a warp loads the row's index j, warp shuffles
//   give every lane all A, and each lane issues all A neighbour loads
//   before its first add: two rounds, indices then rows.
//   With one chunk per thread (128 threads for a 250-wide row read as
//   float2) the serve readout is 853 rows x 128 threads, one wave over all
//   132 SMs (`rows` kind); what is left is the launch, about 1.2 us of the
//   2.2 us the readout takes.
// - HBM bytes, at request scale (a 4,096-molecule batch: 101 MB of h, read
//   once, with the locality of molecular graphs).  The `tiled` kind is a
//   persistent grid of SMs x resident blocks that walks tiles of rows; each
//   lane loads its index of its next row while the current row's loads are
//   in flight, so one round of latency per row is on the critical path.
//   (Registers and shuffles rather than shared memory: a warp needs only its
//   own row's A indices, so staging them would add a barrier and buy
//   nothing.  Neither kind uses shared memory.)  About 80 % of the bytes
//   bound.  At uniformly random indices the non-persistent `rows` grid was
//   a few per cent faster; `plan` sees only shapes and keeps `tiled` for
//   the batches molecules give.
// - The L2, at large random gathers whose table fits in it: each row of h is
//   read A times over.  Stores of out are streaming (`__stcs`, evict-first):
//   out is written once and would otherwise push h out of the L2.
// - Asynchronous copies: a ring of neighbour rows in shared memory, filled
//   by `cp.async` (8-byte copies at H = 250), was slower on the card than
//   the better of the two register kinds at every case (PERF.md, section 6):
//   registers already keep more bytes in flight than the memory needs.  So
//   there is none.  TMA (`cp.async.bulk`, tensor maps) cannot address these
//   rows at all: at H = 250 a row is 1,000 bytes, odd rows start 8 bytes
//   off a 16-byte boundary and the row stride is not a multiple of 16.
// - Tensor cores have no part in a gather-sum: it does A adds per element
//   loaded, far below the rate at which the memory system feeds them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block; ops/nei_sum.py agrees
constexpr int kGroup = 8;         // neighbours in flight in the generic path

enum Kind { kRows = 0, kTiled = 1 };

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

// A row's A indices: lane j of the warp loads index j, the warp's shuffles
// hand all A to every lane.  One load per lane instead of A; a warp never
// spans two rows (threads per row are a multiple of 32), so the whole warp
// takes part in each shuffle.
template <int A>
__device__ __forceinline__ int32_t my_idx(const int32_t* g) {
  const int lane = threadIdx.x & 31;
  return __ldg(g + (lane < A ? lane : 0));
}

template <int A>
__device__ __forceinline__ void share_idx(int32_t (&idx)[A], int32_t mine) {
#pragma unroll
  for (int j = 0; j < A; ++j) idx[j] = __shfl_sync(0xffffffffu, mine, j);
}

// Column chunk c of the row whose A neighbours are idx: all A loads are
// issued before the first add.
template <typename V, int A>
__device__ __forceinline__ V sum_row(const V* __restrict__ h,
                                     const int32_t (&idx)[A], int64_t cols,
                                     int64_t c) {
  V v[A];
#pragma unroll
  for (int j = 0; j < A; ++j) v[j] = __ldg(h + static_cast<int64_t>(idx[j]) * cols + c);
  V acc = v[0];
#pragma unroll
  for (int j = 1; j < A; ++j) add_to(acc, v[j]);
  return acc;
}

// Any A: neighbours in groups of kGroup, each group's loads in flight
// together, the sum in order.
template <typename V>
__device__ __forceinline__ V sum_row_any(const V* __restrict__ h,
                                         const int32_t* __restrict__ g, int a,
                                         int64_t cols, int64_t c) {
  V acc = zero<V>();
  for (int j0 = 0; j0 < a; j0 += kGroup) {
    int32_t idx[kGroup];
    V v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j0 + j < a) idx[j] = __ldg(g + j0 + j);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j0 + j < a) v[j] = __ldg(h + static_cast<int64_t>(idx[j]) * cols + c);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j0 + j < a) add_to(acc, v[j]);
    }
  }
  return acc;
}

// All kinds take the same arguments; A == 0 is the generic path (runtime a).

// `rows`: one tile of blockDim.y rows per block, for grids of one wave.
template <typename V, int A>
__global__ void __launch_bounds__(kMaxThreads)
nei_sum_kernel_rows(const float* __restrict__ hf, const int32_t* __restrict__ graph,
                    float* __restrict__ outf, int64_t n, int32_t a, int64_t cols) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const V* h = reinterpret_cast<const V*>(hf);
  V* dst = reinterpret_cast<V*>(outf) + row * cols;
  if constexpr (A > 0) {
    int32_t idx[A];
    share_idx<A>(idx, my_idx<A>(graph + row * A));
    for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
      __stcs(dst + c, sum_row<V, A>(h, idx, cols, c));
    }
  } else {
    for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
      __stcs(dst + c, sum_row_any<V>(h, graph + row * a, a, cols, c));
    }
  }
}

// `tiled`: a persistent grid; block b takes tiles b, b + gridDim.x, ...
// and each thread prefetches its next row's indices into registers.
template <typename V, int A>
__global__ void __launch_bounds__(kMaxThreads)
nei_sum_kernel_tiled(const float* __restrict__ hf, const int32_t* __restrict__ graph,
                     float* __restrict__ outf, int64_t n, int32_t a, int64_t cols) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.y;
  int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const V* h = reinterpret_cast<const V*>(hf);
  V* out = reinterpret_cast<V*>(outf);
  if constexpr (A > 0) {
    int32_t mine = row < n ? my_idx<A>(graph + row * A) : 0;
    for (; row < n; row += stride) {
      const int32_t nxt = row + stride < n ? my_idx<A>(graph + (row + stride) * A) : 0;
      int32_t idx[A];
      share_idx<A>(idx, mine);
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
        __stcs(out + row * cols + c, sum_row<V, A>(h, idx, cols, c));
      }
      mine = nxt;
    }
  } else {
    for (; row < n; row += stride) {
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
        __stcs(out + row * cols + c, sum_row_any<V>(h, graph + row * a, a, cols, c));
      }
    }
  }
}

using Kernel = void (*)(const float*, const int32_t*, float*, int64_t, int32_t,
                        int64_t);

template <typename V, int A>
Kernel pick_kind(int kind) {
  switch (kind) {
    case kRows: return nei_sum_kernel_rows<V, A>;
    case kTiled: return nei_sum_kernel_tiled<V, A>;
    default: return nullptr;
  }
}

template <typename V>
Kernel pick_width(int kind, int a_tmpl) {
  switch (a_tmpl) {
    case 0: return pick_kind<V, 0>(kind);
    case 1: return pick_kind<V, 1>(kind);
    case 2: return pick_kind<V, 2>(kind);
    case 3: return pick_kind<V, 3>(kind);
    case 4: return pick_kind<V, 4>(kind);
    case 5: return pick_kind<V, 5>(kind);
    case 6: return pick_kind<V, 6>(kind);
    case 7: return pick_kind<V, 7>(kind);
    case 8: return pick_kind<V, 8>(kind);
    default: return nullptr;
  }
}

Kernel pick(int kind, int vec, int a_tmpl) {
  switch (vec) {
    case 1: return pick_width<float>(kind, a_tmpl);
    case 2: return pick_width<float2>(kind, a_tmpl);
    case 4: return pick_width<float4>(kind, a_tmpl);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Blocks of `threads` threads that fit on one SM at once for the kernel
// (kind, vec, a_tmpl); -1 if no such kernel exists or the query fails.
int ggpm_nei_sum_blocks_per_sm(int kind, int vec, int a_tmpl, int threads) {
  Kernel k = pick(kind, vec, a_tmpl);
  if (k == nullptr) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, reinterpret_cast<const void*>(k), threads, 0) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// Launches the plan on `stream` and returns the launch's error, else
// cudaGetLastError() (0 on success).  cols = H / vec; a_tmpl is A when
// 1 <= A <= 8, else 0 (the generic path).
int ggpm_nei_sum_f32(const float* h, const int32_t* graph, float* out, int64_t n,
                     int64_t a, int64_t cols, int kind, int vec, int a_tmpl,
                     int tpr, int rpb, int64_t grid, void* stream) {
  Kernel k = pick(kind, vec, a_tmpl);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int32_t a32 = static_cast<int32_t>(a);
  void* args[] = {&h, &graph, &out, &n, &a32, &cols};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(k), dim3(static_cast<unsigned>(grid)),
      dim3(tpr, rpb), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
