// Neighbour gather-sum for Hopper (sm_90a):
//
//     out[n, :] = sum_{a < A} h[graph[n, a], :]
//
// h is f32 or bf16 [M, H], graph int32 [N, A], out [N, H] in h's type.
// Row 0 of h is the zero padding row, so padded slots of graph (index 0)
// add nothing and need no mask (the kernel loads them all the same).  The
// sum runs in the fixed order a = 0..A-1 in fp32 registers; a bf16 h is
// loaded packed (2, 4 or 8 elements a load), widened to f32 exactly, and
// the sum is rounded to bf16 once, at the store (round to nearest even):
// what the JAX models compute, whose `jnp.sum` of a bf16 table accumulates
// in f32 and rounds once.
//
// Replaces the Pallas TPU kernel `_kernel` of ggpm_tpu/ops/pallas_gather.py
// (launched by `_nei_sum_pallas_impl`, wrapped by `nei_sum_pallas`), which
// serves the message-passing readouts of ggpm_tpu/models/encoder.py.  That
// kernel walks its grid in order on one core and double-buffers one DMA of
// an aligned 8-row block of h per neighbour into a VMEM accumulator carried
// across steps.  Here blocks run in parallel in no order and nothing is
// carried: each output row belongs to `tpr` threads (threadIdx.x) of one
// block, each thread owns one column chunk of V = float, float2 or float4,
// or of 1, 2, 4 or 8 bf16 (the widest the row alignment allows), and a
// block holds `rpb` rows (threadIdx.y).  The launch plan (kind, V, A, tpr, rpb, grid) is chosen by `plan` in ops/nei_sum.py; this file checks nothing
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block; ops/nei_sum.py agrees

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
constexpr int kGroup = 8;         // neighbours in flight in the generic path

enum Kind { kRows = 0, kTiled = 1 };
enum Dtype { kF32 = 0, kBF16 = 1 };

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

// How a column chunk is loaded, summed and stored.  F32<V>: loads of V =
// float, float2 or float4, summed as they are.  BF16<N>: loads of N packed
// bf16 (2, 4, 8 or 16 bytes), summed in N f32 registers, rounded once at
// the store.
template <typename V>
struct F32 {
  using Ld = V;
  using Acc = V;
  static __device__ __forceinline__ Ld load(const Ld* p) { return __ldg(p); }
  static __device__ __forceinline__ Acc widen(Ld v) { return v; }
  static __device__ __forceinline__ Acc zeros() { return zero<V>(); }
  static __device__ __forceinline__ void add(Acc& acc, Ld v) { add_to(acc, v); }
  static __device__ __forceinline__ void store(Ld* p, const Acc& acc) { __stcs(p, acc); }
};

template <int N> struct BfLoad;
template <> struct BfLoad<1> { using T = unsigned short; };
template <> struct BfLoad<2> { using T = unsigned int; };
template <> struct BfLoad<4> { using T = uint2; };
template <> struct BfLoad<8> { using T = uint4; };

template <int N>
struct Floats {
  float v[N];
};

template <int N>
struct BF16 {
  using Ld = typename BfLoad<N>::T;
  using Acc = Floats<N>;
  static __device__ __forceinline__ Ld load(const Ld* p) { return __ldg(p); }
  static __device__ __forceinline__ Acc widen(Ld v) {
    Acc a;
    if constexpr (N == 1) {
      a.v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&v));
    } else {
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float2 f = __bfloat1622float2(b2[i]);
        a.v[2 * i] = f.x;
        a.v[2 * i + 1] = f.y;
      }
    }
    return a;
  }
  static __device__ __forceinline__ Acc zeros() {
    Acc a;
#pragma unroll
    for (int i = 0; i < N; ++i) a.v[i] = 0.f;
    return a;
  }
  static __device__ __forceinline__ void add(Acc& acc, Ld v) {
    const Acc w = widen(v);
#pragma unroll
    for (int i = 0; i < N; ++i) acc.v[i] += w.v[i];
  }
  static __device__ __forceinline__ void store(Ld* p, const Acc& acc) {
    Ld out;
    if constexpr (N == 1) {
      const __nv_bfloat16 b = __float2bfloat16_rn(acc.v[0]);
      out = *reinterpret_cast<const unsigned short*>(&b);
    } else {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        o2[i] = __float22bfloat162_rn(make_float2(acc.v[2 * i], acc.v[2 * i + 1]));
      }
    }
    __stcs(p, out);
  }
};

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
template <typename IO, int A>
__device__ __forceinline__ typename IO::Acc sum_row(
    const typename IO::Ld* __restrict__ h, const int32_t (&idx)[A], int64_t cols,
    int64_t c) {
  typename IO::Ld v[A];
#pragma unroll
  for (int j = 0; j < A; ++j) v[j] = IO::load(h + static_cast<int64_t>(idx[j]) * cols + c);
  typename IO::Acc acc = IO::widen(v[0]);
#pragma unroll
  for (int j = 1; j < A; ++j) IO::add(acc, v[j]);
  return acc;
}

// Any A: neighbours in groups of kGroup, each group's loads in flight
// together, the sum in order.
template <typename IO>
__device__ __forceinline__ typename IO::Acc sum_row_any(
    const typename IO::Ld* __restrict__ h, const int32_t* __restrict__ g, int a,
    int64_t cols, int64_t c) {
  typename IO::Acc acc = IO::zeros();
  for (int j0 = 0; j0 < a; j0 += kGroup) {
    int32_t idx[kGroup];
    typename IO::Ld v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j0 + j < a) idx[j] = __ldg(g + j0 + j);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j0 + j < a) v[j] = IO::load(h + static_cast<int64_t>(idx[j]) * cols + c);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j0 + j < a) IO::add(acc, v[j]);
    }
  }
  return acc;
}

// All kinds take the same arguments; A == 0 is the generic path (runtime a).

// `rows`: one tile of blockDim.y rows per block, for grids of one wave.
template <typename IO, int A>
__global__ void __launch_bounds__(kMaxThreads)
nei_sum_kernel_rows(const void* __restrict__ hv, const int32_t* __restrict__ graph,
                    void* __restrict__ outv, int64_t n, int32_t a, int64_t cols) {
  using Ld = typename IO::Ld;
  count_device_launch();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const Ld* h = reinterpret_cast<const Ld*>(hv);
  Ld* dst = reinterpret_cast<Ld*>(outv) + row * cols;
  if constexpr (A > 0) {
    int32_t idx[A];
    share_idx<A>(idx, my_idx<A>(graph + row * A));
    for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
      IO::store(dst + c, sum_row<IO, A>(h, idx, cols, c));
    }
  } else {
    for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
      IO::store(dst + c, sum_row_any<IO>(h, graph + row * a, a, cols, c));
    }
  }
}

// `tiled`: a persistent grid; block b takes tiles b, b + gridDim.x, ...
// and each thread prefetches its next row's indices into registers.
template <typename IO, int A>
__global__ void __launch_bounds__(kMaxThreads)
nei_sum_kernel_tiled(const void* __restrict__ hv, const int32_t* __restrict__ graph,
                     void* __restrict__ outv, int64_t n, int32_t a, int64_t cols) {
  using Ld = typename IO::Ld;
  count_device_launch();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.y;
  int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const Ld* h = reinterpret_cast<const Ld*>(hv);
  Ld* out = reinterpret_cast<Ld*>(outv);
  if constexpr (A > 0) {
    int32_t mine = row < n ? my_idx<A>(graph + row * A) : 0;
    for (; row < n; row += stride) {
      const int32_t nxt = row + stride < n ? my_idx<A>(graph + (row + stride) * A) : 0;
      int32_t idx[A];
      share_idx<A>(idx, mine);
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
        IO::store(out + row * cols + c, sum_row<IO, A>(h, idx, cols, c));
      }
      mine = nxt;
    }
  } else {
    for (; row < n; row += stride) {
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) {
        IO::store(out + row * cols + c, sum_row_any<IO>(h, graph + row * a, a, cols, c));
      }
    }
  }
}

using Kernel = void (*)(const void*, const int32_t*, void*, int64_t, int32_t,
                        int64_t);

template <typename IO, int A>
Kernel pick_kind(int kind) {
  switch (kind) {
    case kRows: return nei_sum_kernel_rows<IO, A>;
    case kTiled: return nei_sum_kernel_tiled<IO, A>;
    default: return nullptr;
  }
}

template <typename IO>
Kernel pick_width(int kind, int a_tmpl) {
  switch (a_tmpl) {
    case 0: return pick_kind<IO, 0>(kind);
    case 1: return pick_kind<IO, 1>(kind);
    case 2: return pick_kind<IO, 2>(kind);
    case 3: return pick_kind<IO, 3>(kind);
    case 4: return pick_kind<IO, 4>(kind);
    case 5: return pick_kind<IO, 5>(kind);
    case 6: return pick_kind<IO, 6>(kind);
    case 7: return pick_kind<IO, 7>(kind);
    case 8: return pick_kind<IO, 8>(kind);
    default: return nullptr;
  }
}

// vec: elements per chunk (f32: 1, 2, 4; bf16: 1, 2, 4, 8).
Kernel pick(int dtype, int kind, int vec, int a_tmpl) {
  if (dtype == kF32) {
    switch (vec) {
      case 1: return pick_width<F32<float>>(kind, a_tmpl);
      case 2: return pick_width<F32<float2>>(kind, a_tmpl);
      case 4: return pick_width<F32<float4>>(kind, a_tmpl);
      default: return nullptr;
    }
  }
  if (dtype == kBF16) {
    switch (vec) {
      case 1: return pick_width<BF16<1>>(kind, a_tmpl);
      case 2: return pick_width<BF16<2>>(kind, a_tmpl);
      case 4: return pick_width<BF16<4>>(kind, a_tmpl);
      case 8: return pick_width<BF16<8>>(kind, a_tmpl);
      default: return nullptr;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Blocks of `threads` threads that fit on one SM at once for the kernel
// (dtype, kind, vec, a_tmpl); -1 if no such kernel exists or the query
// fails.
int ggpm_nei_sum_blocks_per_sm(int dtype, int kind, int vec, int a_tmpl,
                               int threads) {
  Kernel k = pick(dtype, kind, vec, a_tmpl);
  if (k == nullptr) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, reinterpret_cast<const void*>(k), threads, 0) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// Launches the plan on `stream` and returns the launch's error, else
// cudaGetLastError() (0 on success).  dtype 0 is f32, 1 bf16; cols = H /
// vec; a_tmpl is A when 1 <= A <= 8, else 0 (the generic path).
int ggpm_nei_sum(const void* h, const int32_t* graph, void* out, int64_t n,
                 int64_t a, int64_t cols, int dtype, int kind, int vec,
                 int a_tmpl, int tpr, int rpb, int64_t grid, void* stream) {
  Kernel k = pick(dtype, kind, vec, a_tmpl);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int32_t a32 = static_cast<int32_t>(a);
  void* args[] = {&h, &graph, &out, &n, &a32, &cols};
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
