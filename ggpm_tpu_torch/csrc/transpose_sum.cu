// Transpose gather-sum for Hopper (sm_90a): the backward of nei_sum.cu's
// neighbour gather-sum and of the depth loop's row gather (gather_rows.cu),
//
//     out[m, :] = sum_{k < K} mask[m, k] * g[t_idx[m, k] / div, :]
//
// over the host-built transpose of the forward's index table
// (ggpm_tpu_torch/ops/graph_ops.py:build_transpose): t_idx int32 [M, K]
// lists the flat positions n * A + a that read row m (row 0 left out),
// t_mask f32 [M, K] marks the real entries (0 or 1).  For nei_sum's
// backward g is the output's cotangent [N, W] and div = A; for the row
// gather's, g is the gathered tensor's cotangent flattened to [N * A, W]
// and div = 1.  A gather over a table, not a scatter-add: no atomics, and
// the sum runs in the fixed order k = 0..K-1 in fp32 registers, so it is
// deterministic.  Masked entries are not loaded.  g and out are f32, or
// bf16 (the cotangents of the encoders' bf16 depth loops and readouts):
// a bf16 g is loaded packed, widened to f32 exactly, summed in f32 and
// rounded to bf16 once, at the store, as JAX's `jnp.sum` of the bf16
// products accumulates in f32 and rounds once; t_mask stays f32.
//
// Replaces `_nei_sum_t_bwd` and `_gather_nd_t_bwd` of
// ggpm_tpu/ops/graph_ops.py (:111, :134), the JAX package's backward of the
// Pallas kernel `_kernel` (ggpm_tpu/ops/pallas_gather.py:33) and of the
// depth loop's gather, which it left to XLA's gathers.  Each output row
// belongs to `tpr` threads (threadIdx.x) of a block holding `rpb` rows
// (threadIdx.y); thread x owns the column chunks x, x + tpr, ..., x + (C -
// 1) tpr of V = float, float2 or float4, or of 1, 2, 4 or 8 bf16 (the
// widest the row alignment allows).  The launch plan (V, K, C, tpr, rpb, grid) is chosen by
// `plan_t` in ops/nei_sum.py; this file checks nothing that the plan
// decided.
//
// What bounds it on an H100, and what the design does about it (PERF.md,
// section 6, has the card's times at every case, from kernel_bench.py
// --transpose and chip_smoke.py):
// - Latency, at the training step's shapes.  The depth loop's case writes
//   768 rows of 750 floats and reads about 650 distinct rows of g, which the
//   L2 holds because the kernel before it just wrote g; most of its K = 6
//   slots are masked, and most rows have no entry or one.  Above the
//   launch, what is left is two dependent rounds of memory latency (the
//   table, then g) and the stores of out.  So:
//   * a row is one pass: every thread issues the loads of all its C column
//     chunks times all the row's entries before its first add, so no thread
//     waits through a second round and no warp idles in a tail pass.  The
//     loads are predicated instructions, not branches: a branch per entry
//     let the compiler put each later load behind the earlier adds;
//   * lane j of a warp loads entry j's index and weight in the same round,
//     and the warp's shuffles hand all K to every lane; K is a template
//     parameter (1..8, and a generic path in groups of 8), and so is
//     div != 1: the depth loop (div 1) pays no division;
//   * no instruction is spent on a masked entry: the table puts a row's
//     real entries first (build_transpose), so a ballot of the weights gives
//     their count nv, the same in the whole warp, and the warp runs the
//     straight-line code for nv entries (a row with none only stores
//     zeros).  Any other mask takes the predicated path over all K.
//   What stays is the launch, the table round and the stores:
//   `kernel_bench.sweep_transpose` times the same launch with every weight
//   0 (no row of g read) and a plain fill of out beside it.
// - Bytes, at larger shapes: as the forward's `rows` kind.  Stores are
//   ordinary: the backward reads out right away, so it should stay in the
//   L2 (streaming stores measured no faster).
// - What Hopper adds does not fit: programmatic dependent launch (the table
//   round overlapping the tail of the kernel before) measured no gain inside
//   the training step, whose host leaves the card idle between kernels, so
//   the launch is a plain one; TMA cannot address these rows (at W = 750
//   the row stride is 3,000 bytes and odd rows start 8 bytes off a 16-byte
//   boundary); a ring of rows in shared memory filled by `cp.async` lost
//   to registers at every case of the forward (nei_sum.cu), and here each
//   row of g is read by one block only, so nothing would be reused from
//   shared memory; tensor cores have no part in a gather-sum, which does
//   one add per element loaded.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 384;  // threads per block; ops/nei_sum.py agrees

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
constexpr int kGroup = 8;         // entries in flight in the generic path

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

__device__ __forceinline__ float scaled(float v, float w) { return v * w; }
__device__ __forceinline__ float2 scaled(float2 v, float w) {
  return make_float2(v.x * w, v.y * w);
}
__device__ __forceinline__ float4 scaled(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
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

// *p where `pred` holds, else zeros: a predicated load instruction, not a
// branch, so that the compiler keeps all of a thread's loads in flight
// together (a branch per entry makes each later load wait for the
// earlier adds).  The entry is not loaded where `pred` is false.
__device__ __forceinline__ float ldg_if(const float* p, bool pred) {
  float v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\t@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "=&f"(v) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}
__device__ __forceinline__ float2 ldg_if(const float2* p, bool pred) {
  float2 v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "@q ld.global.nc.v2.f32 {%0, %1}, [%2];\n\t}"
      : "=&f"(v.x), "=&f"(v.y) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}
__device__ __forceinline__ float4 ldg_if(const float4* p, bool pred) {
  float4 v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "mov.f32 %2, 0f00000000;\n\tmov.f32 %3, 0f00000000;\n\t"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=&f"(v.x), "=&f"(v.y), "=&f"(v.z), "=&f"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

__device__ __forceinline__ unsigned short ldg_if(const unsigned short* p, bool pred) {
  unsigned short v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "mov.u16 %0, 0;\n\t@q ld.global.nc.u16 %0, [%1];\n\t}"
      : "=&h"(v) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}
__device__ __forceinline__ unsigned int ldg_if(const unsigned int* p, bool pred) {
  unsigned int v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "mov.u32 %0, 0;\n\t@q ld.global.nc.u32 %0, [%1];\n\t}"
      : "=&r"(v) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}
__device__ __forceinline__ uint2 ldg_if(const uint2* p, bool pred) {
  uint2 v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
      "mov.u32 %0, 0;\n\tmov.u32 %1, 0;\n\t"
      "@q ld.global.nc.v2.u32 {%0, %1}, [%2];\n\t}"
      : "=&r"(v.x), "=&r"(v.y) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}
__device__ __forceinline__ uint4 ldg_if(const uint4* p, bool pred) {
  uint4 v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\t"
      "mov.u32 %0, 0;\n\tmov.u32 %1, 0;\n\t"
      "mov.u32 %2, 0;\n\tmov.u32 %3, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=&r"(v.x), "=&r"(v.y), "=&r"(v.z), "=&r"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// How a column chunk is loaded, weighed, summed and stored.  F32<V>: V =
// float, float2 or float4, summed as they are.  BF16<N>: N packed bf16
// (2, 4, 8 or 16 bytes), summed in N f32 registers, rounded once at the
// store.
template <typename V>
struct F32 {
  using Ld = V;
  using Acc = V;
  static __device__ __forceinline__ Ld load_if(const Ld* p, bool pred) {
    return ldg_if(p, pred);
  }
  static __device__ __forceinline__ Acc zeros() { return zero<V>(); }
  static __device__ __forceinline__ void accum(Acc& acc, Ld v, float w) {
    add_to(acc, scaled(v, w));
  }
  static __device__ __forceinline__ void store(Ld* p, const Acc& acc) { *p = acc; }
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
  static __device__ __forceinline__ Ld load_if(const Ld* p, bool pred) {
    return ldg_if(p, pred);
  }
  static __device__ __forceinline__ Acc zeros() {
    Acc a;
#pragma unroll
    for (int i = 0; i < N; ++i) a.v[i] = 0.f;
    return a;
  }
  static __device__ __forceinline__ void accum(Acc& acc, Ld v, float w) {
    if constexpr (N == 1) {
      acc.v[0] += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&v)) * w;
    } else {
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float2 f = __bfloat1622float2(b2[i]);
        acc.v[2 * i] += f.x * w;
        acc.v[2 * i + 1] += f.y * w;
      }
    }
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
    *p = out;
  }
};

// `count` (<= G) entries of a row from t and m: lane j < count loads entry
// j's index and weight, both loads in one round, and the warp's shuffles
// hand all G to every lane (the weight of a missing entry is 0).  Returns
// the entries whose weight is not 0, one bit each.  A warp never spans two
// rows (threads per row are a multiple of 32), so the whole warp takes part
// in each shuffle and the bits are the same in all its lanes.
template <int G, bool kDiv>
__device__ __forceinline__ unsigned entries(const int32_t* __restrict__ t,
                                            const float* __restrict__ m,
                                            int count, int32_t div,
                                            int32_t (&idx)[G], float (&w)[G]) {
  const int lane = threadIdx.x & 31;
  int32_t my_idx = 0;
  float my_w = 0.f;
  if (lane < count) {
    my_idx = __ldg(t + lane);
    my_w = __ldg(m + lane);
  }
  if constexpr (kDiv) my_idx /= div;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    idx[j] = __shfl_sync(0xffffffffu, my_idx, j);
    w[j] = __shfl_sync(0xffffffffu, my_w, j);
  }
  return __ballot_sync(0xffffffffu, my_w != 0.f);
}

// Adds entries j < N (or, with kAny, every entry of G whose weight is not
// 0) to this thread's C chunks c0, c0 + tpr, ...: all loads are issued
// before the first add, and the adds run in entry order.
template <typename IO, int G, int C, int N, bool kAny>
__device__ __forceinline__ void add_entries(typename IO::Acc (&acc)[C],
                                            const typename IO::Ld* __restrict__ g,
                                            const int32_t (&idx)[G],
                                            const float (&w)[G], int64_t cols,
                                            int64_t c0, int tpr) {
  if constexpr (N > 0) {
    typename IO::Ld v[C][N];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int64_t c = c0 + static_cast<int64_t>(i) * tpr;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[i][j] = IO::load_if(g + static_cast<int64_t>(idx[j]) * cols + c,
                              c < cols && (!kAny || w[j] != 0.f));
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) IO::accum(acc[i], v[i][j], w[j]);
    }
  }
}

// The row's entries whose weight is not 0 (`valid`), in entry order.  The
// table puts a row's real entries first (build_transpose), so `valid` is a
// prefix of nv entries, and the warp takes the straight-line code for nv
// (nv = 0 stores zeros and loads nothing): no instruction is spent on a
// masked entry.  Any other mask takes the predicated path over all G.
template <typename IO, int G, int C, int N = 0>
__device__ __forceinline__ void add_valid(typename IO::Acc (&acc)[C],
                                          const typename IO::Ld* __restrict__ g,
                                          const int32_t (&idx)[G],
                                          const float (&w)[G], unsigned valid,
                                          int64_t cols, int64_t c0, int tpr) {
  if constexpr (N > G) {
    add_entries<IO, G, C, G, true>(acc, g, idx, w, cols, c0, tpr);
  } else {
    if (valid == (1u << N) - 1u) {
      add_entries<IO, G, C, N, false>(acc, g, idx, w, cols, c0, tpr);
    } else {
      add_valid<IO, G, C, N + 1>(acc, g, idx, w, valid, cols, c0, tpr);
    }
  }
}

template <typename IO, int C>
__device__ __forceinline__ void store(typename IO::Ld* __restrict__ dst,
                                      const typename IO::Acc (&acc)[C],
                                      int64_t cols, int64_t c0, int tpr) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int64_t c = c0 + static_cast<int64_t>(i) * tpr;
    if (c < cols) IO::store(dst + c, acc[i]);
  }
}

// K == 0 is the generic path (runtime k, entries in groups of kGroup).  A
// row is one pass over its columns when tpr * C >= cols, as the plan makes
// it for rows up to 2 * kMaxThreads chunks (ops/nei_sum.py: MAX_CHUNKS).
template <typename IO, int K, int C, bool kDiv>
__global__ void __launch_bounds__(kMaxThreads)
transpose_sum_kernel(const void* __restrict__ gv, const int32_t* __restrict__ t_idx,
                     const float* __restrict__ t_mask, void* __restrict__ outv,
                     int64_t n, int32_t k, int32_t div, int64_t cols) {
  using Ld = typename IO::Ld;
  using Acc = typename IO::Acc;
  count_device_launch();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const Ld* g = reinterpret_cast<const Ld*>(gv);
  Ld* dst = reinterpret_cast<Ld*>(outv) + row * cols;
  const int tpr = blockDim.x;
  const int64_t step = static_cast<int64_t>(tpr) * C;
  if constexpr (K > 0) {
    int32_t idx[K];
    float w[K];
    const unsigned valid =
        entries<K, kDiv>(t_idx + row * K, t_mask + row * K, K, div, idx, w);
    for (int64_t c0 = threadIdx.x; c0 < cols; c0 += step) {
      Acc acc[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = IO::zeros();
      add_valid<IO, K, C>(acc, g, idx, w, valid, cols, c0, tpr);
      store<IO, C>(dst, acc, cols, c0, tpr);
    }
  } else {
    const int32_t* t = t_idx + row * k;
    const float* m = t_mask + row * k;
    for (int64_t c0 = threadIdx.x; c0 < cols; c0 += step) {
      Acc acc[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = IO::zeros();
      for (int j0 = 0; j0 < k; j0 += kGroup) {
        int32_t idx[kGroup];
        float w[kGroup];
        const unsigned valid = entries<kGroup, kDiv>(
            t + j0, m + j0, min(kGroup, k - j0), div, idx, w);
        add_valid<IO, kGroup, C>(acc, g, idx, w, valid, cols, c0, tpr);
      }
      store<IO, C>(dst, acc, cols, c0, tpr);
    }
  }
}

using Kernel = void (*)(const void*, const int32_t*, const float*, void*,
                        int64_t, int32_t, int32_t, int64_t);

template <typename IO, int K, int C>
Kernel pick_div(bool by_div) {
  return by_div ? transpose_sum_kernel<IO, K, C, true>
                : transpose_sum_kernel<IO, K, C, false>;
}

template <typename IO, int K>
Kernel pick_chunks(int chunks, bool by_div) {
  switch (chunks) {
    case 1: return pick_div<IO, K, 1>(by_div);
    case 2: return pick_div<IO, K, 2>(by_div);
    default: return nullptr;
  }
}

template <typename IO>
Kernel pick_k(int k_tmpl, int chunks, bool by_div) {
  switch (k_tmpl) {
    case 0: return pick_chunks<IO, 0>(chunks, by_div);
    case 1: return pick_chunks<IO, 1>(chunks, by_div);
    case 2: return pick_chunks<IO, 2>(chunks, by_div);
    case 3: return pick_chunks<IO, 3>(chunks, by_div);
    case 4: return pick_chunks<IO, 4>(chunks, by_div);
    case 5: return pick_chunks<IO, 5>(chunks, by_div);
    case 6: return pick_chunks<IO, 6>(chunks, by_div);
    case 7: return pick_chunks<IO, 7>(chunks, by_div);
    case 8: return pick_chunks<IO, 8>(chunks, by_div);
    default: return nullptr;
  }
}

// dtype 0 is f32 (vec 1, 2, 4 floats), 1 bf16 (vec 1, 2, 4, 8 elements).
Kernel pick(int dtype, int vec, int k_tmpl, int chunks, bool by_div) {
  if (dtype == 0) {
    switch (vec) {
      case 1: return pick_k<F32<float>>(k_tmpl, chunks, by_div);
      case 2: return pick_k<F32<float2>>(k_tmpl, chunks, by_div);
      case 4: return pick_k<F32<float4>>(k_tmpl, chunks, by_div);
      default: return nullptr;
    }
  }
  if (dtype == 1) {
    switch (vec) {
      case 1: return pick_k<BF16<1>>(k_tmpl, chunks, by_div);
      case 2: return pick_k<BF16<2>>(k_tmpl, chunks, by_div);
      case 4: return pick_k<BF16<4>>(k_tmpl, chunks, by_div);
      case 8: return pick_k<BF16<8>>(k_tmpl, chunks, by_div);
      default: return nullptr;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Launches the plan on `stream` and returns the launch's error, else
// cudaGetLastError() (0 on success).  g [*, W], t_idx and t_mask [n, k],
// out [n, W]; dtype 0 is f32, 1 bf16 (g and out); cols = W / vec; k_tmpl
// is k when 1 <= k <= 8, else 0.
int ggpm_transpose_sum(const void* g, const int32_t* t_idx, const float* t_mask,
                       void* out, int64_t n, int64_t k, int64_t div, int64_t cols,
                       int dtype, int vec, int k_tmpl, int chunks, int tpr,
                       int rpb, int64_t grid, void* stream) {
  if (div < 1) return static_cast<int>(cudaErrorInvalidValue);
  Kernel kern = pick(dtype, vec, k_tmpl, chunks, div != 1);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int32_t k32 = static_cast<int32_t>(k);
  int32_t div32 = static_cast<int32_t>(div);
  void* args[] = {&g, &t_idx, &t_mask, &out, &n, &k32, &div32, &cols};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kern), dim3(static_cast<unsigned>(grid)),
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
