// Row-wise weighted membership counts for NVIDIA Hopper (sm_90a).
//
//   out[b, k] = sum_s w[b, s] * [query[b, k] == ids[b, s]]
//
// Replaces the Pallas TPU kernel ocn_tpu/ops/pallas/membership.py
// (membership_counts -> _kernel), the hand-written lowering of the compare
// branch of ocn_tpu/ops/frame.py _rowwise_membership.  On the cn5 main path
// it builds cn1 (candidates N(i) looked up in N(j)) and cn2 (N(i) looked up
// in the capped A^2 row of j) for every link chunk, or for every frame group
// of 8 chunks (32,768 rows) in the bench program.  Duplicate ids in a row
// add their weights, exactly like the dense compare-and-sum.
//
// Bound on this card: the kernel must read B*(4*Kq + 8*Ks) bytes and write
// 4*B*Kq: at (B, Kq, Ks) = (4096, 64, 64) 4.19 MB, 1.25 us at 3.35 TB/s; at
// a frame group's (32768, 64, 64) 33.6 MB, 10.0 us.  The B*Kq*Ks compares
// and adds (0.5 and 4.0 us at the 67 TFLOP/s float32 rate) come after.  What
// limits a simple design is neither: it is the shared-memory instructions,
// two scalar loads per compare when each thread owns one query lane.
//
// Design: register blocking.  Each thread owns 4 consecutive query lanes of
// one row (4 ids and 4 float sums in registers); a row takes ceil(Kq/4)
// threads (at most 64, and Kq past 256 takes further passes), so a block of
// 128 threads covers 8 rows at Kq=64 and 32 at Kq=16 (small blocks keep all
// SMs busy at 4,096 rows).  The block stages its rows' ids and w in shared
// memory with coalesced loads (16-byte ones where Ks is a multiple of 4),
// walking (row, entry) with no integer division; each row is padded to a
// multiple of 4 entries with w = 0 (adding 0.0 leaves a sum as it is, so
// the id there does not matter), the row stride an odd number of 16-byte
// groups so that the rows a warp reads sit in distinct banks.  The inner
// loop steps s by 4: one 16-byte load of 4 ids and one of 4 weights,
// broadcast to the row's threads, feed 16 compares and predicated adds - 2
// shared loads per 16 compares, where one lane a thread costs 2 per
// compare.  Each sum still runs in ascending s from 0.0f, as the TPU
// kernel's does, so unit weights give exact integers and results do not
// move.  Ks is tiled through shared memory (24 KB a block); ragged B and Kq
// are masked.  No wgmma or TMA: there is no matrix product, and the bytes
// are few.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;              // query lanes a thread owns
constexpr int kMaxThreadsPerRow = 64;  // 64 * kLanes query lanes a pass
constexpr int kSmemBytes = 24 * 1024;  // staged ids and weights per block

__global__ void __launch_bounds__(kThreads)
membership_kernel(const int32_t* __restrict__ query,
                  const int32_t* __restrict__ ids,
                  const float* __restrict__ w,
                  float* __restrict__ out,
                  int64_t rows, int kq, int ks, int tpr, int rpb, int tile,
                  int stride, bool vec) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_ids = smem;                                        // [rpb][stride]
  float* s_w = reinterpret_cast<float*>(smem + rpb * stride);   // [rpb][stride]
  const int tid = threadIdx.x;
  const int r = tid / tpr;       // this thread's row in the block
  const int g = tid - r * tpr;   // its group of kLanes query lanes
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t left = rows - b0;
  const int nrows = left < rpb ? static_cast<int>(left) : rpb;
  const bool row_ok = r < nrows;
  const int64_t b = b0 + r;

  for (int k0 = 0; k0 < kq; k0 += kLanes * tpr) {
    const int kb = k0 + kLanes * g;
    int32_t q[kLanes];
    float acc[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      q[i] = (row_ok && kb + i < kq) ? query[b * kq + kb + i] : 0;
      acc[i] = 0.0f;
    }
    for (int s0 = 0; s0 < ks; s0 += tile) {
      const int n = min(tile, ks - s0);
      const int n4 = (n + 3) & ~3;
      // units a row: 16-byte groups where rows allow (then n == n4), else
      // entries; each thread walks (row, unit) with no division
      const int units = vec ? n4 / 4 : n4;
      const int dr = kThreads / units;
      const int ds = kThreads - dr * units;
      int rr = tid / units;
      int s = tid - rr * units;
      __syncthreads();  // the previous tile is fully consumed
      for (; rr < nrows; rr += dr, s += ds) {
        if (s >= units) {
          s -= units;
          if (++rr >= nrows) break;
        }
        const int64_t src = (b0 + rr) * ks + s0;
        if (vec) {
          reinterpret_cast<int4*>(s_ids + rr * stride)[s] =
              reinterpret_cast<const int4*>(ids + src)[s];
          reinterpret_cast<float4*>(s_w + rr * stride)[s] =
              reinterpret_cast<const float4*>(w + src)[s];
        } else {
          s_ids[rr * stride + s] = s < n ? ids[src + s] : 0;
          s_w[rr * stride + s] = s < n ? w[src + s] : 0.0f;
        }
      }
      __syncthreads();
      if (row_ok && kb < kq) {
        const int4* pi = reinterpret_cast<const int4*>(s_ids + r * stride);
        const float4* pw = reinterpret_cast<const float4*>(s_w + r * stride);
#pragma unroll 4
        for (int s4 = 0; s4 < n4 / 4; ++s4) {
          const int4 iv = pi[s4];
          const float4 wv = pw[s4];
#pragma unroll
          for (int i = 0; i < kLanes; ++i) {
            if (iv.x == q[i]) acc[i] += wv.x;
            if (iv.y == q[i]) acc[i] += wv.y;
            if (iv.z == q[i]) acc[i] += wv.z;
            if (iv.w == q[i]) acc[i] += wv.w;
          }
        }
      }
    }
    if (row_ok) {
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        if (kb + i < kq) out[b * kq + kb + i] = acc[i];
      }
    }
  }
}

}  // namespace

// C interface for ctypes.  All pointers are device pointers of contiguous
// (rows, kq) int32 / (rows, ks) int32 / (rows, ks) float32 / (rows, kq)
// float32 arrays; `stream` is a cudaStream_t.  Returns cudaGetLastError().
extern "C" int ocn_membership_counts(const void* query, const void* ids,
                                     const void* w, void* out, int64_t rows,
                                     int kq, int ks, void* stream) {
  if (rows <= 0 || kq <= 0) return static_cast<int>(cudaGetLastError());
  const int tpr = std::min((kq + kLanes - 1) / kLanes, kMaxThreadsPerRow);
  const int rpb = kThreads / tpr;
  // entries per row the budget holds, less room for the bank padding
  const int cap = (kSmemBytes / (8 * rpb) - 4) / 4 * 4;
  const int tile = std::min((std::max(ks, 1) + 3) / 4 * 4, cap);
  const int stride = tile + ((tile / 4) % 2 == 0 ? 4 : 0);
  const size_t smem = static_cast<size_t>(8) * rpb * stride;
  const unsigned grid = static_cast<unsigned>((rows + rpb - 1) / rpb);
  // 16-byte staging loads: whole groups of 4 entries, aligned rows
  const bool vec = ks % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(ids) |
                    reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  membership_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(query), static_cast<const int32_t*>(ids),
      static_cast<const float*>(w), static_cast<float*>(out), rows, kq, ks,
      tpr, rpb, tile, stride, vec);
  return static_cast<int>(cudaGetLastError());
}
