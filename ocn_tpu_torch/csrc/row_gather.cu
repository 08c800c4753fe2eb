// Row gathers for NVIDIA Hopper (sm_90a): two kernels of one library.
//
//   ocn_row_rows:           out[m, :] = x[clamp(idx[m], 0, N - 1), :]
//   ocn_sorted_block_rows:  out[m, :] = x[ids[m], :]  if base[m / TS] <= ids[m]
//                                        < base[m / TS] + W, else 0
//
// They replace the gather kernels of the row-gather instrument
// scripts/bench_gather.py, which measures the row gathers that every hot
// loop of the system is built from (encoder SpMM x[col], frame matmul
// x[ids]):
//
// * row_rows replaces gather_p (pallas_call at :86, kernel `kern` at :63):
//   one DMA per row of a flat (N*H) table, 16 copies in flight.
// * sorted_block_rows replaces mk_blk -> kern2 (pallas_call at :203): per
//   tile of TS sorted ids it copies a (W, H) block of x from a 16-aligned
//   base and picks the rows with a one-hot matmul on the MXU, so a row whose
//   id lies outside its tile's block comes out as zeros.  That matmul is the
//   TPU's way around scalar-addressed row reads; on Hopper it would cost
//   2*TS*W*H operations per tile (309 GFLOP at the instrument's shapes, many
//   times the byte bound) and its (W, H) block (1.18 MB in bfloat16) does not
//   fit a block's shared memory.  This kernel reads the selected rows
//   directly, with the same range test and zero fill.
//
// Bound on this card: both are copies, bound by bytes.  They must read each
// distinct row they select once, write the output and read the ids (and the
// bases): at the instrument's shapes (M = 262,144 ids over N = 235,868 rows
// of H = 256 bfloat16, 158,154 distinct) 216,243,200 bytes, 0.0646 ms at
// 3.35 TB/s.
//
// Design (simple and right first): a group of tpr threads per output row,
// tpr the smallest power of two >= the row's units, at most a warp, so a
// 512-byte bfloat16 row is one warp moving one 16-byte unit per thread, and
// narrow rows share a warp.  Each group loads its row's id (one broadcast
// read), tests or clamps it, and copies the row in units with neighbouring
// threads on neighbouring addresses; rows go grid-stride.  Memory-level
// parallelism comes from the many rows in flight across the card, not from
// software pipelining.  The unit is the widest of 16/8/4/2/1 bytes that
// divides the row's bytes and both pointers (as in window_gather.cu), so any
// element type and width works.  Ids are int32 or int64; every offset is
// 64-bit.  Sorted ids put neighbouring groups on neighbouring rows, which is
// where the TPU design got its locality; here it shows as L2 hits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_rows_kernel(const T* __restrict__ x, const I* __restrict__ idx,
                T* __restrict__ out, int64_t n, int64_t row_units, int64_t m,
                int tpr) {
  const int per_block = kThreads / tpr;
  const int sub = threadIdx.x % tpr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_block;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * per_block +
                   threadIdx.x / tpr;
       r < m; r += stride) {
    int64_t s = static_cast<int64_t>(idx[r]);
    s = s < 0 ? 0 : (s < n ? s : n - 1);
    const T* src = x + s * row_units;
    T* dst = out + r * row_units;
    for (int64_t u = sub; u < row_units; u += tpr) dst[u] = src[u];
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
sorted_block_rows_kernel(const T* __restrict__ x, const I* __restrict__ ids,
                         const I* __restrict__ bases, T* __restrict__ out,
                         int64_t n, int64_t row_units, int64_t m, int64_t ts,
                         int64_t w, int tpr) {
  const int per_block = kThreads / tpr;
  const int sub = threadIdx.x % tpr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_block;
  const T zero{};
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * per_block +
                   threadIdx.x / tpr;
       r < m; r += stride) {
    const int64_t id = static_cast<int64_t>(ids[r]);
    const int64_t base = static_cast<int64_t>(bases[r / ts]);
    T* dst = out + r * row_units;
    // the one-hot row of the TPU kernel has a 1 at lane id - base when that
    // lane exists; the id must also name a row of x
    if (id >= base && id - base < w && id >= 0 && id < n) {
      const T* src = x + id * row_units;
      for (int64_t u = sub; u < row_units; u += tpr) dst[u] = src[u];
    } else {
      for (int64_t u = sub; u < row_units; u += tpr) dst[u] = zero;
    }
  }
}

// threads per row: the smallest power of two >= the row's units, at most 32
int threads_per_row(int64_t row_units) {
  int tpr = 1;
  while (tpr < 32 && tpr < row_units) tpr *= 2;
  return tpr;
}

unsigned grid_for(int64_t rows, int tpr) {
  const int64_t per_block = kThreads / tpr;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  const int64_t max_grid = 2147483647;
  return static_cast<unsigned>(blocks < max_grid ? blocks : max_grid);
}

// calls f with a value of the widest unit type that divides align
template <typename F>
void by_unit(uint64_t align, F&& f) {
  if (align % 16 == 0) {
    f(uint4{});
  } else if (align % 8 == 0) {
    f(uint2{});
  } else if (align % 4 == 0) {
    f(uint32_t{});
  } else if (align % 2 == 0) {
    f(uint16_t{});
  } else {
    f(uint8_t{});
  }
}

uint64_t alignment(const void* x, const void* out, int64_t row_bytes) {
  return reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
         static_cast<uint64_t>(row_bytes);
}

}  // namespace

// C interface for ctypes.  x: device pointer to a contiguous (n, row_bytes)
// byte table; idx: device pointer to (m,) ids, int64 when idx64 else int32;
// out: device pointer to a contiguous (m, row_bytes) byte array; stream: a
// cudaStream_t.  Returns cudaGetLastError().
extern "C" int ocn_row_rows(const void* x, const void* idx, int idx64,
                            void* out, int64_t n, int64_t row_bytes,
                            int64_t m, void* stream) {
  if (m <= 0 || row_bytes <= 0 || n <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_unit(alignment(x, out, row_bytes), [&](auto unit) {
    using T = decltype(unit);
    const int64_t units = row_bytes / static_cast<int64_t>(sizeof(T));
    const int tpr = threads_per_row(units);
    const unsigned grid = grid_for(m, tpr);
    if (idx64) {
      row_rows_kernel<T, int64_t><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const int64_t*>(idx),
          static_cast<T*>(out), n, units, m, tpr);
    } else {
      row_rows_kernel<T, int32_t><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const int32_t*>(idx),
          static_cast<T*>(out), n, units, m, tpr);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

// ids: (m,) sorted ids and bases: (ceil(m / ts),) tile bases, both int64
// when idx64 else int32; ts: ids per tile; w: rows per tile block.
extern "C" int ocn_sorted_block_rows(const void* x, const void* ids,
                                     const void* bases, int idx64, void* out,
                                     int64_t n, int64_t row_bytes, int64_t m,
                                     int64_t ts, int64_t w, void* stream) {
  if (m <= 0 || row_bytes <= 0 || n <= 0 || ts <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_unit(alignment(x, out, row_bytes), [&](auto unit) {
    using T = decltype(unit);
    const int64_t units = row_bytes / static_cast<int64_t>(sizeof(T));
    const int tpr = threads_per_row(units);
    const unsigned grid = grid_for(m, tpr);
    if (idx64) {
      sorted_block_rows_kernel<T, int64_t><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const int64_t*>(ids),
          static_cast<const int64_t*>(bases), static_cast<T*>(out), n, units,
          m, ts, w, tpr);
    } else {
      sorted_block_rows_kernel<T, int32_t><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const int32_t*>(ids),
          static_cast<const int32_t*>(bases), static_cast<T*>(out), n, units,
          m, ts, w, tpr);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
