// Deterministic sorted segment sums for NVIDIA Hopper (sm_90a).
//
//   out[s, h] = sum_{q in [off[s], off[s+1])} scale[q] * src[idx[q], h]
//
// for S segments given by nondecreasing CSR offsets off (S + 1 of them,
// off[S] <= Q), Q entries, an optional row index idx (int32 or int64; without
// it row q is read) and an optional float32 scale (without it 1).  src is
// float32 or bfloat16 with any row and column strides; out is a contiguous
// (S, H) float32 array; sums are taken in float32.  An empty segment writes
// 0; entries outside [off[0], off[S]) are not read.
//
// Replaces XLA's jax.ops.segment_sum(..., indices_are_sorted=True) of the
// JAX package, not a Pallas kernel: the encoder's SpMM (ocn_tpu/ops/
// spmm.py:49,63) and its transpose-permutation backward, the frames' column
// sums (ocn_tpu/ops/frame.py:509,542) and the frame-matmul backward's dx
// (frame.py:582 and the window variants).  PyTorch's index_add_ sums with
// atomics on the card, so its order, and the bits of every sum with more
// than two terms, change from run to run; XLA's sorted segment sum, like
// this kernel, gives one result for one input.
//
// Bound on this card: bytes.  Each distinct row of src read once, each
// index, scale and offset once, the output written once: at the encoder
// SpMM's (n, nnz, H) = (235,868, 1,324,714, 256) float32 about 0.24 GB +
// 0.24 GB + 16 MB, 0.15 ms at 3.35 TB/s.  This kernel reads each entry's
// row, not each distinct row (nnz * H * 4 = 1.36 GB there, 0.41 ms, mostly
// from HBM since the 241 MB table does not fit the 50 MB L2); at the frame
// dx's (65,536 entries, 235,868 segments, 256) the output alone, 241 MB
// written once, is 0.072 ms of the 0.093 ms bound.
//
// Design: merge-path shares (Merrill and Garland, SC'16), three kernels a
// call.
// 1. seg_partition: the merged list of the S segment ends and the entries
//    in [off[0], off[S]) (end s comes before entry q when off[s+1] <= q) is
//    cut into shares of `share` items, so hubs, the frames' sentinel lanes
//    (10^5-10^6 entries in one segment) and runs of empty segments (the
//    frame dx's 170,000 empty nodes, the column sums' trailing empties) all
//    spread evenly.  No search: a thread reads the offsets of 4 segments
//    and writes the cuts that fall in them.  A cut that falls 1..`snap`
//    entries into a segment moves back to the segment's first entry, so a
//    segment of at most `snap` entries never crosses a share.  A share
//    holds at most share + snap items.
// 2. The share's own pass.  It loads its offsets, rows and scales once
//    (coalesced, into shared memory), writes every segment
//    whose end it holds exactly once, zeros of empty segments included,
//    and, if its last entry's segment runs on past it, that segment's
//    partial sum to carry[b] (its id to carry_seg[b]).  A segment that
//    began in an earlier share gets its local part written; the fix-up
//    adds the rest.
//    * seg_wide (H > 8): a warp a share, walking its items in order, the
//      lanes across the columns.  Rows are read 16 bytes a lane (4 float32
//      or 8 bfloat16 values) where cs == 1, H, the row stride and the base
//      allow it, else 4 or 2 bytes a lane; 8 entries' rows (4 on the
//      scalar path) are loaded before their adds.  Each column of a
//      segment is summed from 0 in increasing q, on either path, so a
//      strided call gives the bits of a contiguous one.  Outputs and
//      carries are stored 16 bytes a lane on the vector path.
//    * seg_narrow (H <= 8): a block a share of up to 1,024 entries,
//      kNarrowPer consecutive entries a thread, summed from 0 in increasing
//      q and restarted at every segment start; the threads' sums meet in a
//      segmented scan, Hillis-Steele over the lanes (offsets 1, 2, 4, 8,
//      16), then in order over the 8 warps; each entry's running sum then
//      gets the sum in progress before its thread.  The outputs of the
//      share's segments are written from shared memory, a thread a row.
// 3. seg_fixup: a segment that crosses shares b .. o - 1 into its owner o
//    has pieces carry[b], ..., carry[o - 1] and the owner's local part.
//    Group g of G adds pieces g, g + G, g + 2G, ... in that order, and the
//    G group sums meet in a binary tree (g += g + half, half from the top
//    power of two down).  G = 256 / (H rounded up to a power of two) on the
//    narrow path, 16 (warps) on the wide one, where the pieces load 16
//    bytes a lane when H is a multiple of 4.  A block looks at 16 shares
//    and leaves at once when none starts such a run.
// The order of the adds is thus fixed by off, Q and H alone, never by the
// schedule, and no value is added atomically.  ops/segment_sum.py
// segment_sum_ordered repeats it in plain PyTorch; the card's tests hold
// this kernel to it bit for bit.
// Products and sums are mul.rn.ftz and add.rn.ftz: never contracted into
// an fma, and subnormal inputs and results flush to zero, as the atomics
// of index_add_ on the card and XLA's sums (the JAX package, CPU and TPU)
// flush them.  Without the flush the incomplete family's column sums of
// underflowing probabilities came out subnormal, where the reference has
// 0, and 1 / colsum overflowed to inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNarrowCols = 8;       // H <= 8 takes the narrow path
constexpr int kNarrowThreads = 256;  // a narrow block, one share
constexpr int kNarrowPer = 4;        // consecutive entries a narrow thread sums
constexpr int kNarrowCap = kNarrowThreads * kNarrowPer;  // items a narrow share holds
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kWideWarps = 4;        // a wide block, one share a warp
constexpr int kWideCap = 192;        // items a wide share holds
constexpr int kWideVecs = 2;         // 16-byte vectors a lane holds in a pass
constexpr int kWideCols = 8;         // columns a lane holds in a scalar pass
constexpr int kPartPer = 4;          // segments a partition thread reads
constexpr int kFixShares = 16;       // shares a fix-up block looks at
constexpr int kFixNarrow = 256;      // narrow fix-up threads
constexpr int kFixWide = 512;        // wide fix-up threads: 16 groups of a warp
constexpr int kFixCols = 8;          // columns a wide fix-up lane holds

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct NoIdx {};

template <typename I>
__device__ __forceinline__ int64_t row_of(const I* __restrict__ idx, int64_t q) {
  return static_cast<int64_t>(idx[q]);
}
__device__ __forceinline__ int64_t row_of(const NoIdx*, int64_t q) { return q; }

// split[0 .. nshares] holds each cut's segment-end count, split[nshares + 1
// ..] its entry count (relative to off[0]).  The ends before cut b are the i
// with key(i) = off[i + 1] - off[0] + i + 1 <= d = b * share (end i precedes
// entry j when off[i + 1] - off[0] <= j), and key increases; so segment i
// (0 .. nseg) holds the cuts with key(i - 1) <= d < key(i), found from the
// offsets read once, coalesced, with no search.  A warp writes its lanes'
// cuts together, 32 at a time, so a segment of 10^6 entries spreads too.
__global__ void __launch_bounds__(256)
seg_partition(const int64_t* __restrict__ off, int64_t nseg, int64_t share,
              int64_t snap, int64_t nshares, int64_t* __restrict__ split) {
  const int lane = threadIdx.x & 31;
  // this warp's segments: kPartPer runs of 32, lanes on neighbouring ones
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x - lane) *
                       kPartPer;
  const int64_t off0 = off[0];
  const int64_t total = nseg + off[nseg] - off0;
  int64_t a[kPartPer], e[kPartPer];
#pragma unroll
  for (int r = 0; r < kPartPer; ++r) {
    const int64_t i = base + 32 * r + lane;
    a[r] = i > 0 && i <= nseg ? off[i] : off0;
    e[r] = i < nseg ? off[i + 1] : 0;
  }
#pragma unroll
  for (int r = 0; r < kPartPer; ++r) {
    const int64_t i = base + 32 * r + lane;
    int64_t lo = total, first = 0, count = 0;
    if (i <= nseg) {
      lo = a[r] - off0 + i;  // key(i - 1); 0 for i = 0
      const int64_t hi = i < nseg ? e[r] - off0 + i + 1 : INT64_MAX;
      first = (lo + share - 1) / share;
      const int64_t last = hi == INT64_MAX ? nshares : (hi - 1) / share;  // b * share < hi
      count = last >= first ? last - first + 1 : 0;
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, count > 0); todo != 0; todo &= todo - 1) {
      const int from = __ffs(todo) - 1;
      const int64_t ii = __shfl_sync(0xffffffffu, i, from);
      const int64_t ilo = __shfl_sync(0xffffffffu, lo, from);
      const int64_t b0 = __shfl_sync(0xffffffffu, first, from);
      const int64_t n = __shfl_sync(0xffffffffu, count, from);
      for (int64_t k = lane; k < n; k += 32) {
        const int64_t b = b0 + k;
        const int64_t d = b * share < total ? b * share : total;
        int64_t j = d - ii;
        const int64_t inside = d - ilo;  // entries of segment ii before the cut
        if (ii < nseg && inside > 0 && inside <= snap) j -= inside;
        split[b] = ii;
        split[nshares + 1 + b] = j;
      }
    }
  }
}

// the share that holds end s: end s is item p = off[s + 1] - off[0] + s of
// the merged list, and cut c lies within snap items before c * share
// (snap < share), so the share is c = p / share or c + 1
__device__ int64_t owner_of(const int64_t* __restrict__ split, const int64_t* __restrict__ off,
                            int64_t nshares, int64_t share, int64_t s) {
  const int64_t p = off[s + 1] - off[0] + s;
  const int64_t c = p / share;
  return c + 1 <= nshares && split[c + 1] <= s ? c + 1 : c;
}

template <typename T, typename I, int kCols>
__global__ void __launch_bounds__(kNarrowThreads)
seg_narrow(const T* __restrict__ src, int64_t rs, int64_t cs,
           const I* __restrict__ idx, const float* __restrict__ scale,
           const int64_t* __restrict__ off, int64_t nseg, int h_cols,
           const int64_t* __restrict__ split, int64_t nshares,
           float* __restrict__ out, float* __restrict__ carry,
           int64_t* __restrict__ carry_seg) {
  __shared__ int64_t send[kNarrowCap + 1];       // off[i0 .. i1]
  __shared__ float sval[kCols][kNarrowCap];      // each entry's final running sum
  __shared__ unsigned char head[kNarrowCap];     // an entry that starts a segment
  __shared__ float wtot[kNarrowWarps][kCols];
  __shared__ float cin[kNarrowWarps][kCols];
  __shared__ unsigned wmask[kNarrowWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int64_t b = blockIdx.x;
  const int64_t i0 = split[b], i1 = split[b + 1];
  const int64_t j0 = split[nshares + 1 + b];
  const int ni = static_cast<int>(i1 - i0);
  const int nj = static_cast<int>(split[nshares + 2 + b] - j0);
  const int64_t q0 = off[0] + j0;
  for (int k = t; k <= ni; k += kNarrowThreads) send[k] = off[i0 + k];
  for (int k = t; k < kNarrowCap; k += kNarrowThreads) head[k] = k == 0;
  // this thread's entries' terms, all loads issued before the adds
  float run[kNarrowPer][kCols];
  float sc[kNarrowPer];
#pragma unroll
  for (int r = 0; r < kNarrowPer; ++r) {
    const int e = t * kNarrowPer + r;
    sc[r] = 1.0f;
#pragma unroll
    for (int h = 0; h < kCols; ++h) run[r][h] = 0.0f;
    if (e < nj) {
      const int64_t q = q0 + e;
      const T* row = src + row_of(idx, q) * rs;
      if (scale != nullptr) sc[r] = scale[q];
#pragma unroll
      for (int h = 0; h < kCols; ++h) {
        if (h < h_cols) run[r][h] = to_f32(row[h * cs]);
      }
    }
  }
  __syncthreads();
  for (int k = t; k < ni; k += kNarrowThreads) {
    const int64_t p = send[k + 1] - q0;
    if (p > 0 && p < nj) head[p] = 1;
  }
  __syncthreads();
  // sum from 0 in increasing q, restarting at the thread's first entry and
  // at every head; first_head: the first entry r that is a head
  float acc[kCols];
  int first_head = kNarrowPer;
#pragma unroll
  for (int h = 0; h < kCols; ++h) acc[h] = 0.0f;
#pragma unroll
  for (int r = 0; r < kNarrowPer; ++r) {
    const int e = t * kNarrowPer + r;
    if (e < nj) {
      const bool hd = head[e] != 0;
      if (hd && first_head == kNarrowPer) first_head = r;
#pragma unroll
      for (int h = 0; h < kCols; ++h) {
        const float term = scale != nullptr ? mul_ftz(sc[r], run[r][h]) : run[r][h];
        acc[h] = add_ftz(hd || r == 0 ? 0.0f : acc[h], term);
        run[r][h] = acc[h];
      }
    }
  }
  // segmented inclusive scan of the threads' sums over the lanes
  const unsigned hmask = __ballot_sync(0xffffffffu, first_head < kNarrowPer);
  const unsigned below = hmask & (0xffffffffu >> (31 - lane));
  const int start = 31 - __clz(below | 1u);
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
#pragma unroll
    for (int h = 0; h < kCols; ++h) {
      const float y = __shfl_up_sync(0xffffffffu, acc[h], d);
      if (lane - d >= start) acc[h] = add_ftz(y, acc[h]);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int h = 0; h < kCols; ++h) wtot[w][h] = acc[h];
  }
  if (lane == 0) wmask[w] = hmask;
  __syncthreads();
  // the sum in progress at the end of each warp, in warp order
  if (t < kCols) {
    float c = wtot[0][t];
    cin[1][t] = c;
    for (int ww = 2; ww < kNarrowWarps; ++ww) {
      c = wmask[ww - 1] != 0 ? wtot[ww - 1][t] : add_ftz(c, wtot[ww - 1][t]);
      cin[ww][t] = c;
    }
  }
  __syncthreads();
  if (w > 0 && below == 0) {
#pragma unroll
    for (int h = 0; h < kCols; ++h) acc[h] = add_ftz(cin[w][h], acc[h]);
  }
  // the sum in progress before this thread, added to its entries up to its
  // first head
#pragma unroll
  for (int h = 0; h < kCols; ++h) {
    const float prev = __shfl_up_sync(0xffffffffu, acc[h], 1);
    const float before = lane > 0 ? prev : (w > 0 ? cin[w][h] : 0.0f);
#pragma unroll
    for (int r = 0; r < kNarrowPer; ++r) {
      const int e = t * kNarrowPer + r;
      if (e < nj && h < h_cols) {
        sval[h][e] = t > 0 && r < first_head ? add_ftz(before, run[r][h]) : run[r][h];
      }
    }
  }
  __syncthreads();
  // every segment whose end this share holds, neighbouring threads on
  // neighbouring rows
  for (int k = t; k < ni; k += kNarrowThreads) {
    const int64_t e = send[k + 1];
    const bool zero = send[k] == e || e <= q0;
    float* o = out + (i0 + k) * h_cols;
#pragma unroll
    for (int h = 0; h < kCols; ++h) {
      if (h < h_cols) o[h] = zero ? 0.0f : sval[h][e - 1 - q0];
    }
  }
  const bool has = nj > 0 && i1 < nseg && send[ni] < q0 + nj;
  if (has && t < h_cols) carry[b * h_cols + t] = sval[t][nj - 1];
  if (t == 0) carry_seg[b] = has ? i1 : -1;
}

// column slots of a wide pass: kW consecutive columns a slot, kSlots slots a
// lane, lanes on neighbouring slots; kAhead entries' rows load before their
// adds
template <typename T>
struct ScalarCols {
  static constexpr int kSlots = kWideCols, kW = 1, kAhead = 4;
  using Raw = T;
  __device__ static Raw load(const T* row, int64_t col, int64_t cs) {
    return row[col * cs];
  }
  __device__ static float get(const Raw& r, int) { return to_f32(r); }
};

template <typename T>
struct VecCols {
  static constexpr int kSlots = kWideVecs, kW = 16 / static_cast<int>(sizeof(T)), kAhead = 8;
  using Raw = uint4;
  __device__ static Raw load(const T* row, int64_t col, int64_t) {
    return __ldg(reinterpret_cast<const uint4*>(row + col));
  }
  __device__ static float get(const Raw& r, int n) {
    const int i = n * static_cast<int>(sizeof(T)) / 4;
    const uint32_t word = i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
    if (sizeof(T) == 4) return __uint_as_float(word);
    // bfloat16: element 2k in the low half of word k
    return __uint_as_float(n % 2 == 0 ? word << 16 : word & 0xffff0000u);
  }
};

template <int kW>
__device__ __forceinline__ void store_cols(float* p, const float (&a)[kW]) {
  if constexpr (kW == 1) {
    p[0] = a[0];
  } else {
#pragma unroll
    for (int n = 0; n < kW; n += 4) {
      *reinterpret_cast<float4*>(p + n) = make_float4(a[n], a[n + 1], a[n + 2], a[n + 3]);
    }
  }
}

// one pass of a warp over its share for the columns from c0
template <typename T, typename Cols>
__device__ __forceinline__ void wide_pass(
    const T* __restrict__ src, int64_t rs, int64_t cs,
    const int64_t* s_off, const int64_t* s_row, const float* s_scale, bool scaled,
    int ni, int nj, int64_t i0, int64_t q0, int h_cols, int64_t c0, int lane,
    bool has, float* __restrict__ out, float* __restrict__ carry_row) {
  constexpr int kS = Cols::kSlots, kW = Cols::kW, kAhead = Cols::kAhead;
  int64_t col[kS];
  bool live[kS];
  float acc[kS][kW];
#pragma unroll
  for (int u = 0; u < kS; ++u) {
    col[u] = c0 + static_cast<int64_t>(lane + 32 * u) * kW;
    live[u] = col[u] < h_cols;
#pragma unroll
    for (int n = 0; n < kW; ++n) acc[u][n] = 0.0f;
  }
  auto emit = [&](int64_t s) {
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      if (live[u]) store_cols<kW>(out + s * h_cols + col[u], acc[u]);
#pragma unroll
      for (int n = 0; n < kW; ++n) acc[u][n] = 0.0f;
    }
  };
  int k = 0;  // the share's ends passed so far
  for (int e0 = 0; e0 < nj; e0 += kAhead) {
    typename Cols::Raw raw[kAhead][kS];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (e0 + a < nj) {
        const T* row = src + s_row[e0 + a] * rs;
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          if (live[u]) raw[a][u] = Cols::load(row, col[u], cs);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (e0 + a < nj) {
        const int64_t q = q0 + e0 + a;
        while (k < ni && s_off[k + 1] <= q) emit(i0 + k++);
        const float sc = s_scale[e0 + a];
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          if (live[u]) {
#pragma unroll
            for (int n = 0; n < kW; ++n) {
              const float v = Cols::get(raw[a][u], n);
              acc[u][n] = add_ftz(acc[u][n], scaled ? mul_ftz(sc, v) : v);
            }
          }
        }
      }
    }
  }
  while (k < ni) emit(i0 + k++);
  if (has) {
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      if (live[u]) store_cols<kW>(carry_row + col[u], acc[u]);
    }
  }
}

template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kWideWarps * 32)
seg_wide(const T* __restrict__ src, int64_t rs, int64_t cs,
         const I* __restrict__ idx, const float* __restrict__ scale,
         const int64_t* __restrict__ off, int64_t nseg, int h_cols,
         const int64_t* __restrict__ split, int64_t nshares,
         float* __restrict__ out, float* __restrict__ carry,
         int64_t* __restrict__ carry_seg) {
  __shared__ int64_t s_off[kWideWarps][kWideCap + 1];
  __shared__ int64_t s_row[kWideWarps][kWideCap];
  __shared__ float s_scale[kWideWarps][kWideCap];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWideWarps + w;
  if (b >= nshares) return;  // the whole warp; nothing below syncs the block
  const int64_t i0 = split[b], i1 = split[b + 1];
  const int64_t j0 = split[nshares + 1 + b];
  const int ni = static_cast<int>(i1 - i0);
  const int nj = static_cast<int>(split[nshares + 2 + b] - j0);
  const int64_t q0 = off[0] + j0;
  for (int k = lane; k <= ni; k += 32) s_off[w][k] = off[i0 + k];
  for (int k = lane; k < nj; k += 32) {
    s_row[w][k] = row_of(idx, q0 + k);
    s_scale[w][k] = scale != nullptr ? scale[q0 + k] : 1.0f;
  }
  __syncwarp();
  const bool has = nj > 0 && i1 < nseg && s_off[w][ni] < q0 + nj;
  if (lane == 0) carry_seg[b] = has ? i1 : -1;
  using Cols = typename std::conditional<kVec, VecCols<T>, ScalarCols<T>>::type;
  constexpr int64_t kPass = 32 * Cols::kSlots * Cols::kW;
  for (int64_t c0 = 0; c0 < h_cols; c0 += kPass) {
    wide_pass<T, Cols>(src, rs, cs, s_off[w], s_row[w], s_scale[w], scale != nullptr,
                       ni, nj, i0, q0, h_cols, c0, lane, has, out,
                       carry + b * h_cols);
  }
}

// adds the pieces of every segment that crosses shares (see the header):
// thread t is group t / width, column slot t % width; a slot holds kSlots
// runs of kW consecutive columns (kW = 4: 16-byte loads), width * kW
// columns apart; kAhead of a group's pieces load before their adds
template <int kThreads, int kSlots, int kW, int kAhead>
__global__ void __launch_bounds__(kThreads, 2)
seg_fixup(const int64_t* __restrict__ split, const int64_t* __restrict__ off,
          int64_t nshares, int64_t share, int h_cols, int width,
          const float* __restrict__ carry, const int64_t* __restrict__ carry_seg,
          float* __restrict__ out) {
  constexpr int kCols = kSlots * kW;
  __shared__ float red[kCols][kThreads];
  __shared__ int64_t segs[kFixShares + 1];  // carry_seg[b0 - 1 .. b0 + kFixShares - 1]
  const int t = threadIdx.x;
  const int g = t / width, slot = t - g * width;
  const int gmax = kThreads / width;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kFixShares;
  if (t <= kFixShares) {
    const int64_t b = b0 - 1 + t;
    segs[t] = b >= 0 && b < nshares ? carry_seg[b] : -1;
  }
  __syncthreads();
  for (int kk = 0; kk < kFixShares; ++kk) {
    const int64_t b = b0 + kk;
    const int64_t s = segs[kk + 1];
    if (s < 0 || segs[kk] == s) continue;  // not a run's first share
    const int64_t m = owner_of(split, off, nshares, share, s) - b;  // pieces 0 .. m
    const int groups = m + 1 < gmax ? static_cast<int>(m + 1) : gmax;
    int top = 1;
    while (top < groups) top *= 2;
    for (int64_t c0 = 0; c0 < h_cols; c0 += static_cast<int64_t>(width) * kCols) {
      int64_t col[kSlots];
      bool live[kSlots];
      float acc[kSlots][kW];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        col[u] = c0 + static_cast<int64_t>(slot + width * u) * kW;
        live[u] = col[u] < h_cols && g < groups;
#pragma unroll
        for (int n = 0; n < kW; ++n) acc[u][n] = 0.0f;
      }
      // piece k: carry[b + k] for k < m, the owner's local part for k = m
      auto load = [&](int64_t k, int u, float (&v)[kW]) {
        const float* p = (k < m ? carry + (b + k) * h_cols : out + s * h_cols) + col[u];
        if constexpr (kW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(p);
          v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
        } else {
          v[0] = *p;
        }
      };
      bool first = true;
      for (int64_t k0 = g; k0 <= m; k0 += kAhead * static_cast<int64_t>(groups)) {
        float v[kAhead][kSlots][kW];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int64_t k = k0 + a * static_cast<int64_t>(groups);
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            if (live[u] && k <= m) load(k, u, v[a][u]);
          }
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          if (k0 + a * static_cast<int64_t>(groups) <= m) {
#pragma unroll
            for (int u = 0; u < kSlots; ++u) {
#pragma unroll
              for (int n = 0; n < kW; ++n) {
                acc[u][n] = first ? v[a][u][n] : add_ftz(acc[u][n], v[a][u][n]);
              }
            }
            first = false;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
#pragma unroll
        for (int n = 0; n < kW; ++n) red[u * kW + n][t] = acc[u][n];
      }
      __syncthreads();
      for (int half = top / 2; half > 0; half /= 2) {
        if (g < half && g + half < groups) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (live[c / kW]) red[c][t] = add_ftz(red[c][t], red[c][t + half * width]);
          }
        }
        __syncthreads();
      }
      if (g == 0) {
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          if (live[u]) {
#pragma unroll
            for (int n = 0; n < kW; ++n) out[s * h_cols + col[u] + n] = red[u * kW + n][t];
          }
        }
      }
      __syncthreads();
    }
  }
}

struct Call {
  const void* src;
  int64_t rs, cs;
  const void* idx;
  const float* scale;
  const int64_t* off;
  int64_t nseg;
  int h;
  const int64_t* split;
  int64_t nshares;
  float* out;
  float* carry;
  int64_t* carry_seg;
  cudaStream_t st;
};

template <typename T, typename I>
void launch_share_pass(const Call& c) {
  const T* src = static_cast<const T*>(c.src);
  const I* idx = static_cast<const I*>(c.idx);
  if (c.h <= kNarrowCols) {
    const unsigned grid = static_cast<unsigned>(c.nshares);
#define OCN_NARROW(K)                                                             \
  seg_narrow<T, I, K><<<grid, kNarrowThreads, 0, c.st>>>(                         \
      src, c.rs, c.cs, idx, c.scale, c.off, c.nseg, c.h, c.split, c.nshares, c.out, \
      c.carry, c.carry_seg)
    if (c.h == 1) {
      OCN_NARROW(1);
    } else if (c.h <= 4) {
      OCN_NARROW(4);
    } else {
      OCN_NARROW(8);
    }
#undef OCN_NARROW
    return;
  }
  constexpr int kW = 16 / static_cast<int>(sizeof(T));
  const bool vec = c.cs == 1 && c.h % kW == 0 && c.rs % kW == 0 &&
                   reinterpret_cast<uintptr_t>(c.src) % 16 == 0;
  const unsigned grid = static_cast<unsigned>((c.nshares + kWideWarps - 1) / kWideWarps);
  if (vec) {
    seg_wide<T, I, true><<<grid, kWideWarps * 32, 0, c.st>>>(
        src, c.rs, c.cs, idx, c.scale, c.off, c.nseg, c.h, c.split, c.nshares, c.out,
        c.carry, c.carry_seg);
  } else {
    seg_wide<T, I, false><<<grid, kWideWarps * 32, 0, c.st>>>(
        src, c.rs, c.cs, idx, c.scale, c.off, c.nseg, c.h, c.split, c.nshares, c.out,
        c.carry, c.carry_seg);
  }
}

template <typename T>
void launch_indexed(const Call& c, int idx_bytes) {
  if (idx_bytes == 8) {
    launch_share_pass<T, int64_t>(c);
  } else if (idx_bytes == 4) {
    launch_share_pass<T, int32_t>(c);
  } else {
    launch_share_pass<T, NoIdx>(c);
  }
}

}  // namespace

// C interface for ctypes.  src: device pointer to float32 (src_bf16 = 0) or
// bfloat16 (1) values, element (r, h) at r * rs + h * cs; idx: device
// pointer to int32 (idx_bytes 4) or int64 (8) rows, or null (0); scale:
// device pointer to float32, or null; off: device pointer to nseg + 1
// nondecreasing int64 offsets, off[nseg] <= Q; out: contiguous (nseg, h)
// float32.  share, snap: items a share holds before and after its cut
// moves (share > snap, share + snap <= 1,024 for h <= 8 and <= 192 above);
// nshares >= ceil((nseg + off[nseg] - off[0]) / share), any more shares are
// empty.  scratch: 16-byte aligned, ocn_segment_sum_scratch(nshares, h)
// int64 words (the cuts, each share's carry segment, its carry row).
// stream: a cudaStream_t.  Launches three kernels; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a share this build cannot
// hold.
extern "C" int64_t ocn_segment_sum_scratch(int64_t nshares, int64_t h) {
  const int64_t words = 3 * nshares + 2;  // split, carry_seg
  return words + words % 2 + (nshares * h + 1) / 2;
}

extern "C" int ocn_segment_sum(const void* src, int src_bf16, int64_t rs,
                               int64_t cs, const void* idx, int idx_bytes,
                               const void* scale, const void* off, int64_t nseg,
                               int64_t h, int64_t share, int64_t snap,
                               int64_t nshares, void* out, void* scratch, void* stream) {
  if (nseg <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  const bool narrow = h <= kNarrowCols;
  if (snap < 0 || share <= snap || share + snap > (narrow ? kNarrowCap : kWideCap) ||
      nshares < 1 || h > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t* split = static_cast<int64_t*>(scratch);
  int64_t* carry_seg = split + 2 * (nshares + 1);
  const int64_t words = 3 * nshares + 2;
  float* carry = reinterpret_cast<float*>(split + words + words % 2);  // 16-byte aligned
  Call c{src, rs, cs, idx, static_cast<const float*>(scale),
         static_cast<const int64_t*>(off), nseg, static_cast<int>(h), split, nshares,
         static_cast<float*>(out), carry, carry_seg, static_cast<cudaStream_t>(stream)};
  seg_partition<<<static_cast<unsigned>((nseg + 256 * kPartPer) / (256 * kPartPer)), 256, 0,
                  c.st>>>(
      c.off, nseg, share, snap, nshares, split);
  if (src_bf16) {
    launch_indexed<__nv_bfloat16>(c, idx_bytes);
  } else {
    launch_indexed<float>(c, idx_bytes);
  }
  const unsigned fix_grid = static_cast<unsigned>((nshares + kFixShares - 1) / kFixShares);
  if (narrow) {
    int width = 1;
    while (width < h) width *= 2;
    seg_fixup<kFixNarrow, 1, 1, 16><<<fix_grid, kFixNarrow, 0, c.st>>>(
        c.split, c.off, nshares, share, c.h, width, c.carry, c.carry_seg, c.out);
  } else if (h % 4 == 0) {  // carry rows and out rows 16-byte aligned
    seg_fixup<kFixWide, kFixCols / 4, 4, 4><<<fix_grid, kFixWide, 0, c.st>>>(
        c.split, c.off, nshares, share, c.h, 32, c.carry, c.carry_seg, c.out);
  } else {
    seg_fixup<kFixWide, kFixCols, 1, 2><<<fix_grid, kFixWide, 0, c.st>>>(
        c.split, c.off, nshares, share, c.h, 32, c.carry, c.carry_seg, c.out);
  }
  return static_cast<int>(cudaGetLastError());
}
