// Uniform negative links for NVIDIA Hopper (sm_90a): candidate pairs from a
// counter-based splitmix64 stream, rejected against the train graph's CSR,
// compacted in candidate order.
//
// Replaces no TPU kernel.  Each epoch draws as many non-edges as there are
// train links; the host sampler (native/graphcore.cpp gc_negative_sampling)
// does it in one thread, a binary search of the sorted edge keys for each
// candidate, while the card waits.  This kernel gives the same links bit for
// bit.  splitmix64 is counter-based, so candidate i (from 0) of seed s (1
// where s is 0) is
//
//   u = mix(s + (2i+1) * gamma) % n,   v = mix(s + (2i+2) * gamma) % n,
//
// the host loop's two draws after 2i+1 and 2i+2 increments of its state.  It
// is accepted iff u != v and v is not in row u of the CSR (indptr, col):
// rows sorted, without duplicates or self-loops, built from the same
// symmetric edge list as the host's keys, so "v in row u" is exactly "u*n+v
// among the keys".  The result is the first `num` accepted candidates among
// the first num*64 + 1024, the host loop's attempts.
//
// Bound on this card: indptr and col read once, the (2, num) int64 output
// written once.  At the collab-sized train graph (n 235,868, 2,358,104
// entries, num 1,179,052) that is 0.94 + 9.43 + 18.86 MB, 8.7 us at 3.35
// TB/s.  What limits it is latency: a candidate's membership test is two
// loads of indptr and about log2(degree) dependent loads of col at a random
// row.  The CSR (10 MB) fits the 50 MB L2, so these are L2 hits after the
// first touch, and a thread's candidates run one after another; enough
// threads in flight hide the latency.
//
// Design: ordered stream compaction in three kernels a round of candidates
// [c0, c0 + count):
//   neg_count  each thread tests kPer consecutive candidates, each block
//              writes how many of its kPer * kThreads it accepted;
//   neg_scan   one block turns the counts into each block's first output
//              slot, on from the running total of earlier rounds, and adds
//              the round's total to it;
//   neg_write  each block whose first slot is below num tests its
//              candidates again; a scan of its threads' counts gives each
//              accepted pair its slot j, written to out[0][j], out[1][j]
//              where j < num.
// Testing twice costs less than keeping the pairs between the passes: the
// hash is a few multiplies and the CSR stays in L2.  The caller over-
// generates (count a little above num: at collab density about 5e-5 of the
// candidates are rejected) and runs another round only where the total
// falls short of num and attempts remain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;  // consecutive candidates a thread tests
constexpr int64_t kBlockCands = static_cast<int64_t>(kThreads) * kPer;
constexpr int kScanThreads = 1024;
constexpr uint64_t kGamma = 0x9e3779b97f4a7c15ULL;

__device__ __forceinline__ uint64_t mix(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Candidate i: its pair, and whether it is a non-edge.
__device__ __forceinline__ bool candidate(const int32_t* __restrict__ indptr,
                                          const int32_t* __restrict__ col,
                                          uint64_t n, uint64_t seed, int64_t i,
                                          int64_t* u_out, int64_t* v_out) {
  const uint64_t k = 2 * static_cast<uint64_t>(i) + 1;
  const int64_t u = static_cast<int64_t>(mix(seed + k * kGamma) % n);
  const int64_t v = static_cast<int64_t>(mix(seed + (k + 1) * kGamma) % n);
  *u_out = u;
  *v_out = v;
  if (u == v) return false;
  const int32_t end = __ldg(indptr + u + 1);
  int32_t lo = __ldg(indptr + u);
  int32_t hi = end;
  const int32_t target = static_cast<int32_t>(v);
  while (lo < hi) {  // lower bound of v in the sorted row
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(col + mid) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo == end || __ldg(col + lo) != target;
}

// Exclusive scan of one value a thread over the block; *total gets the sum.
template <int NT>
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t x, int64_t* total) {
  __shared__ int64_t warp_sums[NT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < NT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < NT / 32) warp_sums[lane] = w;  // inclusive warp prefixes
  }
  __syncthreads();
  const int64_t before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - x;
}

__global__ void __launch_bounds__(kThreads)
neg_count(const int32_t* __restrict__ indptr, const int32_t* __restrict__ col,
          uint64_t n, uint64_t seed, int64_t c0, int64_t count,
          int32_t* __restrict__ counts) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlockCands +
                        static_cast<int64_t>(threadIdx.x) * kPer;
  int c = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    int64_t u, v;
    if (first + p < count && candidate(indptr, col, n, seed, c0 + first + p, &u, &v)) ++c;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
  __shared__ int warp_counts[kWarps];
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_counts[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kScanThreads)
neg_scan(const int32_t* __restrict__ counts, int64_t nblocks,
         int64_t* __restrict__ offsets, int64_t* __restrict__ total) {
  int64_t carry = *total;
  for (int64_t b0 = 0; b0 < nblocks; b0 += kScanThreads) {
    const int64_t b = b0 + threadIdx.x;
    int64_t chunk;
    const int64_t excl = block_exclusive_scan<kScanThreads>(b < nblocks ? counts[b] : 0, &chunk);
    if (b < nblocks) offsets[b] = carry + excl;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
neg_write(const int32_t* __restrict__ indptr, const int32_t* __restrict__ col,
          uint64_t n, uint64_t seed, int64_t c0, int64_t count, int64_t num,
          const int64_t* __restrict__ offsets, int64_t* __restrict__ out) {
  const int64_t slot0 = offsets[blockIdx.x];
  if (slot0 >= num) return;  // the whole block: every slot it owns is past num
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlockCands +
                        static_cast<int64_t>(threadIdx.x) * kPer;
  int64_t us[kPer], vs[kPer];
  bool ok[kPer];
  int c = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    ok[p] = first + p < count && candidate(indptr, col, n, seed, c0 + first + p, &us[p], &vs[p]);
    c += ok[p];
  }
  int64_t unused;
  int64_t j = slot0 + block_exclusive_scan<kThreads>(c, &unused);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (ok[p]) {
      if (j < num) {
        out[j] = us[p];
        out[num + j] = vs[p];
      }
      ++j;
    }
  }
}

}  // namespace

// Blocks of one round of `count` candidates (the length of the caller's
// counts and offsets scratch).
extern "C" int64_t ocn_negatives_blocks(int64_t count) {
  return (count + kBlockCands - 1) / kBlockCands;
}

// One round: candidates [c0, c0 + count) of `seed` against the CSR (indptr,
// col) of n nodes; accepted pairs from the running total *total on go to out
// (2, num) int64 where their slot is below num, and *total grows by the
// round's accepted count.  counts (int32) and offsets (int64) hold
// ocn_negatives_blocks(count) entries.  Returns the CUDA error of the
// launches (0 if none).
extern "C" int ocn_negatives_round(const int32_t* indptr, const int32_t* col, int64_t n,
                                   uint64_t seed, int64_t c0, int64_t count, int64_t num,
                                   int64_t* out, int32_t* counts, int64_t* offsets,
                                   int64_t* total, void* stream) {
  if (n <= 0 || c0 < 0 || count <= 0 || num <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = ocn_negatives_blocks(count);
  if (nblocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t s = seed ? seed : 1;
  const unsigned grid = static_cast<unsigned>(nblocks);
  neg_count<<<grid, kThreads, 0, st>>>(indptr, col, static_cast<uint64_t>(n), s, c0, count,
                                       counts);
  neg_scan<<<1, kScanThreads, 0, st>>>(counts, nblocks, offsets, total);
  neg_write<<<grid, kThreads, 0, st>>>(indptr, col, static_cast<uint64_t>(n), s, c0, count,
                                       num, offsets, out);
  return static_cast<int>(cudaGetLastError());
}
