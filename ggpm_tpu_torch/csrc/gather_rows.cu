// Row gather for Hopper (sm_90a):
//
//     out[r, :] = src[idx[r], :]        for r < n
//
// src [M, W] of any element type (f32 or bf16 here), idx int32 [n] (an
// [N, A] index table read flat), out [n, W] of src's type.  It is the
// forward of the message-passing depth loop's gather of [h | h Kf | c]
// (LSTM, W = 3H = 750 at the canonical width) or [h | h U_r + b_r] (GRU,
// W = 2H = 500) by bgraph, and of the hier scan's message updates (W = H),
// `gather_nd_t` in ggpm_tpu/ops/graph_ops.py, which the JAX package left
// to XLA's gather (no Pallas kernel); its backward is transpose_sum.cu over
// the same table.  A row is copied as bytes, so one kernel serves every
// element type: the copy reads and writes every byte of the rows it
// gathers, row 0 included (the GRU's table holds b_r in row 0, not zeros).
//
// What bounds it on an H100: bytes, and the latency of the two dependent
// loads (index, then row), which only enough bytes in flight hide.  So
// where a row does not fill its threads, they are mapped over the output,
// not over rows: `out` is one contiguous stream of n * R bytes (R = the
// row's bytes) whose base is 16-byte aligned, cut into 16-byte chunks.
// Block b owns `C * blockDim.x` consecutive chunks, several rows where rows
// are short and none left idle at a row's end; its thread t takes chunks
// b * C * blockDim.x + j * blockDim.x + t, j < C, so that each of a warp's
// accesses covers 512 consecutive bytes.  A thread first loads the row
// indices of all its chunks, then issues all of their loads into
// registers, then makes its stores.  On the card more chunks a thread did
// not pay: one is fastest until the stream holds about 8 waves of threads,
// two beyond (four or eight lost 5-65 %; PERF.md, section 6), so the grid,
// not the thread, keeps the bytes in flight; what the mapping over the
// output removed is the per-row launch's idle threads at a row's end.
// Stores are ordinary 16-byte stores: the depth round and the scan step
// read the gathered tensor right away, so it should stay in the L2.  Each
// chunk's row is found by a multiply-high (`divide`), not a division,
// which would lengthen the chain before the index load.
//
// Rows start at the alignment of src plus idx[r] * R, which changes from
// row to row when R is not a multiple of 16 (a bf16 row of 750 is 1,500
// bytes; an f32 row of 250, 1,000).  Two paths (`Kind`, chosen by `plan`
// in ops/gather_rows.py from R, the element size and the base pointers'
// alignment):
//   * kRows, the kernel's first mapping: a row per `tpr` threads, `rpb`
//     rows a block, each thread copying accesses x, x + tpr, ... of the
//     widest width (2, 4, 8 or 16 bytes) that R and both bases allow.  The
//     plan takes it where a row is one pass that fills at least 15/16 of
//     the warps it takes (rows of 1,000 and 2,000 bytes: 125 accesses of 8
//     or 16 bytes for 128 threads; there it stays ahead of the stream below
//     by 2-5 % on the card, PERF.md section 6), and for every row that
//     kBlocks does not take (a bf16 row of odd width, a source base 2 bytes
//     off a 4-byte boundary, a row of fewer than 16 bytes).
//   * kBlocks, where R is a multiple of 4 of at least 16 bytes, src 4-byte
//     and out 16-byte aligned: a chunk inside one source row is read as the
//     one or two aligned 16-byte blocks that hold it and realigned by words
//     in registers; a chunk that runs into the next row, or the stream's
//     ragged last chunk, is read as 4-byte words.  An aligned block holds a
//     byte of the row it is read for, so it never reaches past the 16-byte
//     granule of the row's first or last byte.  Four 4-byte loads a chunk
//     instead were at best 2 % ahead at a call site and up to 7 % behind.
// TMA is no help here: it needs 16-byte aligned rows.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block; ops/gather_rows.py agrees
// words (rows on kRows) a launch may copy, so that no chunk offset of a
// grid that covers them overflows 32 bits
constexpr int64_t kMaxTotal = (int64_t{1} << 31) - 1;

enum Kind { kBlocks = 0, kRows = 1 };

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

// x / d for 0 <= x < 2^31, by d's (mul, shr) from `divider` in
// ops/gather_rows.py (mul 0: d is 1): a multiply-high and a shift instead
// of a division, whose latency would delay every chunk's index load.
__device__ __forceinline__ uint32_t divide(uint32_t x, uint32_t mul, uint32_t shr) {
  return mul ? __umulhi(x, mul) >> shr : x;
}

// The four words of the window a|b that start at word s (0..3).
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, uint32_t s) {
  if (s & 2) {
    a = make_uint4(a.z, a.w, b.x, b.y);
    b = make_uint4(b.z, b.w, 0u, 0u);
  }
  if (s & 1) a = make_uint4(a.y, a.z, a.w, b.x);
  return a;
}

// Rows of `words` 4-byte words (words >= 4), `total` = n * words <= kMaxTotal.
template <int C>
__global__ void __launch_bounds__(kMaxThreads)
gather_wide(const uint32_t* __restrict__ src, const int32_t* __restrict__ idx,
            uint4* __restrict__ out, uint32_t words, uint32_t mul,
            uint32_t shr, uint32_t total) {
  count_device_launch();
  const uint32_t first = blockIdx.x * (C * blockDim.x) + threadIdx.x;
  // 1. each chunk's row and column, and the indices of the rows it reads
  int64_t at[C], next[C];  // word offsets in src of the chunk's words
  uint32_t here[C], have[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const uint32_t o = 4 * (first + j * blockDim.x);  // the chunk's first word
    have[j] = o < total ? min(4u, total - o) : 0u;    // its words in out
    const uint32_t r = have[j] ? divide(o, mul, shr) : 0u;
    const uint32_t c = o - r * words;
    here[j] = min(4u, words - c);                     // of them in row r
    const int32_t i0 = have[j] ? __ldg(idx + r) : 0;
    const int32_t i1 = here[j] < have[j] ? __ldg(idx + r + 1) : 0;
    at[j] = static_cast<int64_t>(i0) * words + c;
    // word k >= here of the chunk is src[next + k], in row i1
    next[j] = static_cast<int64_t>(i1) * words - here[j];
  }
  // 2. every chunk's loads
  uint4 a[C], b[C];
  uint32_t s[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    a[j] = b[j] = make_uint4(0u, 0u, 0u, 0u);
    s[j] = 0;
    if (have[j] == 4 && here[j] == 4) {
      const uintptr_t p = reinterpret_cast<uintptr_t>(src + at[j]);
      const uint4* blk = reinterpret_cast<const uint4*>(p & ~uintptr_t(15));
      s[j] = static_cast<uint32_t>(p >> 2) & 3u;
      a[j] = __ldg(blk);
      if (s[j]) b[j] = __ldg(blk + 1);
    } else if (have[j]) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = k < static_cast<int>(have[j])
                   ? __ldg(src + (k < static_cast<int>(here[j]) ? at[j] : next[j]) + k)
                   : 0u;
      }
      a[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  // 3. the stores
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (!have[j]) continue;
    const uint4 v = realign(a[j], b[j], s[j]);
    const uint32_t q = first + j * blockDim.x;
    if (have[j] == 4) {
      out[q] = v;
    } else {  // the stream's ragged last chunk
      uint32_t* to = reinterpret_cast<uint32_t*>(out + q);
      to[0] = v.x;
      if (have[j] > 1) to[1] = v.y;
      if (have[j] > 2) to[2] = v.z;
    }
  }
}

// kRows: one row per `tpr` = blockDim.x threads, each copying accesses of
// V (the widest that the row's bytes and both bases allow) threadIdx.x,
// threadIdx.x + tpr, ... of the row's `cols`, blockDim.y rows a block: the
// kernel's first design, its offsets in 64 bits as there.
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
gather_by_row(const void* __restrict__ srcv, const int32_t* __restrict__ idx,
              void* __restrict__ outv, uint32_t row_cols, uint32_t, uint32_t,
              uint32_t n) {
  count_device_launch();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const int64_t cols = row_cols;
  const V* from = reinterpret_cast<const V*>(srcv) +
                  static_cast<int64_t>(__ldg(idx + row)) * cols;
  V* to = reinterpret_cast<V*>(outv) + row * cols;
  for (int64_t c = threadIdx.x; c < cols; c += blockDim.x) to[c] = __ldg(from + c);
}

using Kernel = void (*)(const void*, const int32_t*, void*, uint32_t, uint32_t,
                       uint32_t, uint32_t);

Kernel pick(int kind, int vec, int chunks) {
  if (kind == kBlocks && vec == 16) {
    if (chunks == 1) return reinterpret_cast<Kernel>(gather_wide<1>);
    if (chunks == 2) return reinterpret_cast<Kernel>(gather_wide<2>);
    return nullptr;
  }
  if (kind != kRows || chunks != 1) return nullptr;
  switch (vec) {
    case 2: return reinterpret_cast<Kernel>(gather_by_row<unsigned short>);
    case 4: return reinterpret_cast<Kernel>(gather_by_row<unsigned int>);
    case 8: return reinterpret_cast<Kernel>(gather_by_row<uint2>);
    case 16: return reinterpret_cast<Kernel>(gather_by_row<uint4>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the plan on `stream` and returns the launch's error, else
// cudaGetLastError() (0 on success).  row_bytes = the row's bytes; vec =
// the bytes of one chunk (16 on kBlocks, the access's on kRows); (mul,
// shr) = `divider` of the row's 4-byte words on kBlocks (unused on kRows);
// threads = the block's threads, on kRows min(the row's accesses rounded
// up to a warp, threads) a row.  A plan the kernel cannot take (a path on
// rows or pointers it does not fit, a stream of more than kMaxTotal words
// or rows, a grid that does not cover it) returns cudaErrorInvalidValue and
// launches nothing.
int ggpm_gather_rows(const void* src, const int32_t* idx, void* out, int64_t n,
                     int64_t row_bytes, int kind, int vec, int chunks,
                     int threads, int64_t grid, uint32_t mul, uint32_t shr,
                     void* stream) {
  const Kernel k = pick(kind, vec, chunks);
  const bool wide = kind == kBlocks;
  const int64_t unit = wide ? 4 : vec;  // the bytes the kernel's offsets count
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (k == nullptr || n <= 0 || row_bytes <= 0 || row_bytes % unit ||
      s % unit || o % vec || threads <= 0 || threads > kMaxThreads ||
      threads % 32 || grid <= 0 || grid > 0x7fffffff ||
      (wide && row_bytes < 16) || row_bytes / unit > kMaxTotal) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint32_t per_row = static_cast<uint32_t>(row_bytes / unit);
  const int64_t total = wide ? n * per_row : n;
  // kRows: threads a row
  const int tpr = static_cast<int>(
      std::min<int64_t>((per_row + 31) / 32 * 32, threads));
  const bool covered = wide ? grid * chunks * threads >= (total + 3) / 4
                            : threads % tpr == 0 && grid * (threads / tpr) >= n;
  if (total > kMaxTotal || !covered) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint32_t total32 = static_cast<uint32_t>(total);
  void* args[] = {&src, &idx, &out, &per_row, &mul, &shr, &total32};
  const dim3 block = wide ? dim3(threads) : dim3(tpr, threads / tpr);
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(k), dim3(static_cast<unsigned>(grid)),
      block, args, 0, static_cast<cudaStream_t>(stream));
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
