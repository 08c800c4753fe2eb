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
// Order of the adds: fixed by q and the tile length alone, never by the
// schedule.  The entries are cut into tiles of `tile` consecutive q.  A
// segment inside one tile is summed in increasing q by one thread a column.
// A segment that crosses tiles is summed piece by piece (each piece in
// increasing q, within its tile), then its pieces are added by one block in
// a fixed pattern: group g of the block adds pieces g, g + G, g + 2G, ... in
// that order, and the G group sums meet in a fixed binary tree.  No atomics.
//
// Bound on this card: bytes.  Each distinct row of src read once, each
// index, scale and offset once, the output written once: at the encoder
// SpMM's (n, nnz, H) = (235,868, 1,324,714, 256) float32 about 0.24 GB +
// 0.24 GB + 16 MB, 0.15 ms at 3.35 TB/s.  A simple design reads each entry's
// row, not each distinct row: nnz * H * 4 = 1.36 GB there, mostly from HBM
// since the table (241 MB) does not fit in L2.
//
// Design, two kernels a call:
// 1. seg_tiles: thread (tile t, column h), neighbouring threads on
//    neighbouring columns (coalesced rows when H >= 32, neighbouring tiles
//    when H is small).  It finds the segment holding the tile's first entry
//    by binary search, walks the tile's entries once and writes each segment
//    that ends inside the tile straight to out; the piece of a segment that
//    began in an earlier tile goes to head[t], the piece of one that runs
//    past the tile to tail[t] (its id to tail_seg[t]).  Runs of empty
//    segments are skipped by galloping search; the same kernel zeroes every
//    empty segment, up to a warp a segment, coalesced over the columns.
// 2. seg_spans: persistent blocks of 256 threads over (tile, column tile of
//    up to 32 columns); a tile whose tail_seg is set adds that segment's
//    pieces, tail[t0], head[t0 + 1], ..., head[t1], as described above, in
//    G = min(256 / columns, pieces) groups.
//    Segments of 10,000 or a million entries (a hub row, the frames'
//    sentinel lanes) thus spread over many threads in both passes.
// Loads of four entries are issued before their adds, which stay in order.
// Products and sums are mul.rn.ftz and add.rn.ftz: never contracted into
// an fma, so a segment inside one tile gives the bits of float32 index_add_
// run in index order on the CPU, and subnormal inputs and results flush to
// zero, as the atomics of index_add_ on the card and XLA's sums (the JAX
// package, CPU and TPU) flush them.  Without the flush the incomplete
// family's column sums of underflowing probabilities came out subnormal,
// where the reference has 0, and 1 / colsum overflowed to inf.
// Later work: vector loads, shared-memory staging of the indices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpanCols = 32;  // columns a seg_spans work item covers

__device__ __forceinline__ float to_f32(float v) { return v; }

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// smallest i in [lo, hi) with off[i] > v, hi if none (off nondecreasing)
__device__ int64_t upper_bound(const int64_t* __restrict__ off, int64_t lo,
                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (off[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the same over [lo, n), galloping from lo: cheap when the answer is near
__device__ int64_t upper_bound_from(const int64_t* __restrict__ off, int64_t n,
                                    int64_t lo, int64_t v) {
  int64_t step = 1, hi = lo;
  while (hi < n && off[hi] <= v) {
    lo = hi + 1;
    hi += step;
    step *= 2;
  }
  return upper_bound(off, lo, hi < n ? hi : n, v);
}

struct NoIdx {};

template <typename I>
__device__ __forceinline__ int64_t row_of(const I* __restrict__ idx, int64_t q) {
  return static_cast<int64_t>(idx[q]);
}
__device__ __forceinline__ int64_t row_of(const NoIdx*, int64_t q) { return q; }

// sum over q in [a, e) of scale[q] * src[row(q), h], in increasing q
template <typename T, typename I, bool kScale>
__device__ float run_sum(const T* __restrict__ src, int64_t rs, int64_t cs,
                         const I* __restrict__ idx, const float* __restrict__ scale,
                         int64_t h, int64_t a, int64_t e) {
  float acc = 0.0f;
  const T* col = src + h * cs;
  int64_t q = a;
  for (; q + 4 <= e; q += 4) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = to_f32(col[row_of(idx, q + k) * rs]);
      if (kScale) v[k] = mul_ftz(scale[q + k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = add_ftz(acc, v[k]);
  }
  for (; q < e; ++q) {
    float v = to_f32(col[row_of(idx, q) * rs]);
    if (kScale) v = mul_ftz(scale[q], v);
    acc = add_ftz(acc, v);
  }
  return acc;
}

template <typename T, typename I, bool kScale>
__global__ void __launch_bounds__(kThreads)
seg_tiles(const T* __restrict__ src, int64_t rs, int64_t cs,
          const I* __restrict__ idx, const float* __restrict__ scale,
          const int64_t* __restrict__ off, int64_t nseg, int64_t nq,
          int64_t h_cols, int64_t tile, int64_t ntiles, float* __restrict__ out,
          float* __restrict__ head, float* __restrict__ tail,
          int64_t* __restrict__ tail_seg) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // empty segments: a group of g threads a segment (g the power of two at
  // or above H, at most a warp) writes its zeros, neighbouring threads on
  // neighbouring columns
  int64_t g = 1;
  while (g < h_cols && g < 32) g *= 2;
  for (int64_t s = first / g; s < nseg; s += stride / g) {
    if (off[s] == off[s + 1]) {
      for (int64_t h = first % g; h < h_cols; h += g) out[s * h_cols + h] = 0.0f;
    }
  }
  for (int64_t i = first; i < ntiles * h_cols; i += stride) {
    const int64_t t = i / h_cols;
    const int64_t h = i - t * h_cols;
    const int64_t q0 = t * tile;
    const int64_t q1 = q0 + tile < nq ? q0 + tile : nq;
    int64_t spanning = -1;
    // the segment holding q0, or the first one after it
    int64_t p = q0;
    int64_t s = upper_bound(off, 0, nseg + 1, q0) - 1;
    if (s < 0) {
      p = off[0];
      s = upper_bound(off, 0, nseg + 1, p) - 1;
    }
    while (p < q1 && s < nseg) {
      const int64_t e = off[s + 1];
      const int64_t end = e < q1 ? e : q1;
      const float acc = run_sum<T, I, kScale>(src, rs, cs, idx, scale, h, p, end);
      if (off[s] < q0) {
        head[t * h_cols + h] = acc;       // began in an earlier tile
      } else if (e > q1) {
        tail[t * h_cols + h] = acc;       // runs past this tile
        spanning = s;
      } else {
        out[s * h_cols + h] = acc;
      }
      if (e >= q1) break;
      p = e;
      s = upper_bound_from(off, nseg + 1, s + 1, p) - 1;
    }
    if (h == 0) tail_seg[t] = spanning;
  }
}

__global__ void __launch_bounds__(kThreads)
seg_spans(const int64_t* __restrict__ off, const int64_t* __restrict__ tail_seg,
          const float* __restrict__ head, const float* __restrict__ tail,
          int64_t h_cols, int64_t tile, int64_t ntiles, float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int w = h_cols < kSpanCols ? static_cast<int>(h_cols) : kSpanCols;
  const int c = threadIdx.x % w;
  const int g = threadIdx.x / w;
  const int64_t ctiles = (h_cols + w - 1) / w;
  for (int64_t item = blockIdx.x; item < ntiles * ctiles; item += gridDim.x) {
    const int64_t t0 = item / ctiles;
    const int64_t s = tail_seg[t0];
    if (s < 0) continue;  // uniform across the block
    const int64_t h = (item - t0 * ctiles) * w + c;
    const int64_t m = (off[s + 1] - 1) / tile - t0;  // pieces 0..m
    // groups: as many as the block holds, at most one a piece
    const int groups = static_cast<int>(m + 1 < kThreads / w ? m + 1 : kThreads / w);
    int top = 1;
    while (top < groups) top *= 2;
    const bool live = g < groups && h < h_cols;
    float acc = 0.0f;
    if (live) {
      int64_t j = g;
      for (; j + 3 * groups <= m; j += 4 * groups) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t jk = j + k * groups;
          v[k] = jk == 0 ? tail[t0 * h_cols + h] : head[(t0 + jk) * h_cols + h];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) acc = add_ftz(acc, v[k]);
      }
      for (; j <= m; j += groups) {
        acc = add_ftz(acc, j == 0 ? tail[t0 * h_cols + h]
                                  : head[(t0 + j) * h_cols + h]);
      }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int half = top / 2; half > 0; half /= 2) {
      if (live && g < half && g + half < groups) {
        red[threadIdx.x] = add_ftz(red[threadIdx.x], red[threadIdx.x + half * w]);
      }
      __syncthreads();
    }
    if (live && g == 0) out[s * h_cols + h] = red[c];
    __syncthreads();
  }
}

int grid_for(int64_t threads) {
  int64_t blocks = (threads + kThreads - 1) / kThreads;
  // persistent: a few waves of the card's 132 SMs at most
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename T, typename I, bool kScale>
void launch_tiles(const void* src, int64_t rs, int64_t cs, const void* idx,
                  const float* scale, const int64_t* off, int64_t nseg,
                  int64_t nq, int64_t h, int64_t tile, int64_t ntiles, float* out,
                  float* head, float* tail, int64_t* tail_seg, cudaStream_t st) {
  const int64_t work = ntiles * h > nseg ? ntiles * h : nseg;
  seg_tiles<T, I, kScale><<<grid_for(work), kThreads, 0, st>>>(
      static_cast<const T*>(src), rs, cs, static_cast<const I*>(idx), scale, off,
      nseg, nq, h, tile, ntiles, out, head, tail, tail_seg);
}

template <typename T, typename I>
void launch_scaled(const void* src, int64_t rs, int64_t cs, const void* idx,
                   const float* scale, const int64_t* off, int64_t nseg,
                   int64_t nq, int64_t h, int64_t tile, int64_t ntiles,
                   float* out, float* head, float* tail, int64_t* tail_seg,
                   cudaStream_t st) {
  if (scale != nullptr) {
    launch_tiles<T, I, true>(src, rs, cs, idx, scale, off, nseg, nq, h, tile,
                             ntiles, out, head, tail, tail_seg, st);
  } else {
    launch_tiles<T, I, false>(src, rs, cs, idx, scale, off, nseg, nq, h, tile,
                              ntiles, out, head, tail, tail_seg, st);
  }
}

template <typename T>
void launch_indexed(const void* src, int64_t rs, int64_t cs, const void* idx,
                    int idx_bytes, const float* scale, const int64_t* off,
                    int64_t nseg, int64_t nq, int64_t h, int64_t tile,
                    int64_t ntiles, float* out, float* head, float* tail,
                    int64_t* tail_seg, cudaStream_t st) {
  if (idx_bytes == 8) {
    launch_scaled<T, int64_t>(src, rs, cs, idx, scale, off, nseg, nq, h, tile,
                              ntiles, out, head, tail, tail_seg, st);
  } else if (idx_bytes == 4) {
    launch_scaled<T, int32_t>(src, rs, cs, idx, scale, off, nseg, nq, h, tile,
                              ntiles, out, head, tail, tail_seg, st);
  } else {
    launch_scaled<T, NoIdx>(src, rs, cs, idx, scale, off, nseg, nq, h, tile,
                            ntiles, out, head, tail, tail_seg, st);
  }
}

}  // namespace

// C interface for ctypes.  src: device pointer to float32 (src_bf16 = 0) or
// bfloat16 (1) values, element (r, h) at r * rs + h * cs; idx: device
// pointer to nq int32 (idx_bytes 4) or int64 (8) rows, or null (0); scale:
// device pointer to nq float32, or null; off: device pointer to nseg + 1
// nondecreasing int64 offsets, off[nseg] <= nq; out: contiguous (nseg, h)
// float32; head, tail: (ceil(nq / tile), h) float32 scratch; tail_seg:
// ceil(nq / tile) int64 scratch; stream: a cudaStream_t.  Launches two
// kernels.  Returns cudaGetLastError().
extern "C" int ocn_segment_sum(const void* src, int src_bf16, int64_t rs,
                               int64_t cs, const void* idx, int idx_bytes,
                               const void* scale, const void* off, int64_t nseg,
                               int64_t nq, int64_t h, int64_t tile, void* out,
                               void* head, void* tail, void* tail_seg,
                               void* stream) {
  if (nseg <= 0 || h <= 0 || tile <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t ntiles = (nq + tile - 1) / tile;
  const float* sc = static_cast<const float*>(scale);
  const int64_t* o = static_cast<const int64_t*>(off);
  float* out_f = static_cast<float*>(out);
  float* head_f = static_cast<float*>(head);
  float* tail_f = static_cast<float*>(tail);
  int64_t* ts = static_cast<int64_t*>(tail_seg);
  if (src_bf16) {
    launch_indexed<__nv_bfloat16>(src, rs, cs, idx, idx_bytes, sc, o, nseg, nq, h,
                                  tile, ntiles, out_f, head_f, tail_f, ts, st);
  } else {
    launch_indexed<float>(src, rs, cs, idx, idx_bytes, sc, o, nseg, nq, h, tile,
                          ntiles, out_f, head_f, tail_f, ts, st);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || ntiles == 0) return err;
  const int64_t w = h < kSpanCols ? h : kSpanCols;
  const int64_t items = ntiles * ((h + w - 1) / w);
  const int64_t cap = 132 * 8;
  const unsigned grid = static_cast<unsigned>(items < cap ? items : cap);
  seg_spans<<<grid, kThreads, 0, st>>>(o, ts, head_f, tail_f, h, tile, ntiles, out_f);
  return static_cast<int>(cudaGetLastError());
}
