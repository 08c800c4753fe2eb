// Window gather for NVIDIA Hopper (sm_90a).
//
//   rows[b, j, :] = y[min(starts[b] + j, E - 1), :]    b < B, j < J
//
// Replaces the Pallas TPU kernel ocn_tpu/ops/pallas/window_gather.py
// (window_rows -> _build/kern), which issues one DMA per window.  On the
// window-table path (Config.window_table) it fetches, for every link chunk,
// the feature rows of the candidate frame from the hoisted table
// y = h.detach()[g.col]: each candidate frame is a contiguous CSR window, so
// each window is one contiguous span of J rows of y.  The caller
// (ops/window_gather.py) aligns the starts down to 8 rows and widens the
// window to J = K + 8, as the TPU kernel does, so rows equal the JAX
// function's element for element; the clamp keeps the kernel defined when
// E < J (the TPU kernel is never called there).
//
// Bound on this card: a copy, no arithmetic.  It must read J*H*itemsize
// bytes per window and write as many: at (B, J, H) = (4096, 72, 256) float32
// that is 2 x 302 MB, 0.180 ms at 3.35 TB/s; at (4096, 24, 256) 0.060 ms; at
// the eval batch (65536, 72, 256) 2.88 ms.
//
// Design (simple and right first): one block of 256 threads per window
// (grid-stride past 2^31-1 windows).  A window without clamping is one
// contiguous span of J*row_bytes bytes, copied in units of 16 bytes with
// neighbouring threads on neighbouring addresses and four loads in flight
// per thread before their stores.  The unit is the widest of 16/8/4/2/1
// bytes that divides the row's bytes and both pointers, so an odd width or
// an unaligned pointer takes a narrower (down to a byte-wise) copy.  The
// kernel copies bytes, not floats, so any element type works (float32 now,
// bfloat16 later).  All offsets are 64-bit: at eval B*J*H is 1.2e9 elements.
// B, J, row bytes and E are runtime values.  No TMA: the spans are large and
// contiguous, and plain vector loads already stream them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // loads issued per thread before their stores

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const T* __restrict__ y, const int64_t* __restrict__ starts,
                   T* __restrict__ out, int64_t e, int64_t row_units,
                   int64_t b, int64_t j) {
  const int64_t n = j * row_units;  // units per window
  for (int64_t w = blockIdx.x; w < b; w += gridDim.x) {
    const int64_t p0 = starts[w];
    T* dst = out + w * n;
    int64_t i = threadIdx.x;
    if (p0 + j <= e) {
      const T* src = y + p0 * row_units;  // one contiguous span
      for (; i + (kInFlight - 1) * kThreads < n; i += kInFlight * kThreads) {
        T v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) v[u] = src[i + u * kThreads];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) dst[i + u * kThreads] = v[u];
      }
      for (; i < n; i += kThreads) dst[i] = src[i];
    } else {
      // rows past the end of the table repeat its last row
      for (; i < n; i += kThreads) {
        const int64_t r = i / row_units;
        const int64_t c = i - r * row_units;
        const int64_t row = p0 + r < e - 1 ? p0 + r : e - 1;
        dst[i] = y[row * row_units + c];
      }
    }
  }
}

template <typename T>
void launch(const void* y, const void* starts, void* out, int64_t e,
            int64_t row_bytes, int64_t b, int64_t j, cudaStream_t stream) {
  const int64_t max_grid = 2147483647;
  const unsigned grid = static_cast<unsigned>(b < max_grid ? b : max_grid);
  window_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const int64_t*>(starts),
      static_cast<T*>(out), e, row_bytes / static_cast<int64_t>(sizeof(T)),
      b, j);
}

}  // namespace

// C interface for ctypes.  y: device pointer to a contiguous (e, row_bytes)
// byte table; starts: device pointer to (b,) int64 aligned window starts in
// [0, e); out: device pointer to a contiguous (b, j, row_bytes) byte array;
// stream: a cudaStream_t.  Returns cudaGetLastError().
extern "C" int ocn_window_rows(const void* y, const void* starts, void* out,
                               int64_t e, int64_t row_bytes, int64_t b,
                               int64_t j, void* stream) {
  if (b <= 0 || j <= 0 || row_bytes <= 0 || e <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t align = reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(out) |
                         static_cast<uint64_t>(row_bytes);
  if (align % 16 == 0) {
    launch<uint4>(y, starts, out, e, row_bytes, b, j, s);
  } else if (align % 8 == 0) {
    launch<uint2>(y, starts, out, e, row_bytes, b, j, s);
  } else if (align % 4 == 0) {
    launch<uint32_t>(y, starts, out, e, row_bytes, b, j, s);
  } else if (align % 2 == 0) {
    launch<uint16_t>(y, starts, out, e, row_bytes, b, j, s);
  } else {
    launch<uint8_t>(y, starts, out, e, row_bytes, b, j, s);
  }
  return static_cast<int>(cudaGetLastError());
}
