// Window gather for NVIDIA Hopper (sm_90a).
//
//   p0a[b] = min(floor(pos0[b] / 8) * 8, max(E - J, 0)),  off[b] = pos0[b] - p0a[b]
//   rows[b, j, :] = y[min(p0a[b] + j, E - 1), :]          b < B, j < J
//
// Replaces the Pallas TPU kernel ocn_tpu/ops/pallas/window_gather.py
// (window_rows -> _build/kern), which issues one DMA per window.  On the
// window-table path (Config.window_table) it fetches, for every link chunk,
// the feature rows of the candidate frame from the hoisted table
// y = h.detach()[g.col]: each candidate frame is a contiguous CSR window, so
// each window is one contiguous span of J rows of y.  The start arithmetic
// of aligned_starts (window_gather.py:93 there) runs here, per window, so a
// call is one device kernel: the start is aligned down to 8 rows and the
// window widened to J = K + 8, as the TPU kernel does, so rows equal the JAX
// function's element for element.  The clamp keeps the kernel defined when
// E < J (the TPU kernel is never called there).  Starts must be >= 0.
//
// Bound on this card: a copy, no arithmetic.  It must read each distinct
// row of the windows once and write J*row_bytes per window: at (B, J, H) =
// (4096, 72, 256) float32, about 2 x 302 MB less the rows that neighbouring
// windows share, 0.170 ms at 3.35 TB/s; at (4096, 24, 256) 0.059 ms.
//
// Design: one device kernel a call.  One block of 256 threads per window
// (grid-stride past 2^31-1 windows) computes the window's aligned start and
// offset, then copies.  When E >= J no window clamps (p0a <= E - J), so a
// window is one contiguous span of J*row_bytes bytes in y and in rows,
// copied in the widest unit of 16/8/4/2/1 bytes that divides the row's
// bytes and both pointers, neighbouring threads on neighbouring addresses,
// four loads in flight per thread before their stores.  Rows past the end
// of the table (E < J) repeat its last row.  The copy runs within a few per
// cent of the card's own contiguous copy of the same bytes (``copy_ms`` of
// chip_smoke.py); a persistent grid with eight loads in flight and a TMA
// bulk-copy ring were no faster (PERF.md).  The kernel copies bytes, not
// floats, so any element type works.  All offsets are 64-bit: at eval
// B*J*H is 1.2e9 elements.  pos0 is int32 or int64 with any stride (two
// template instances), read as given.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // loads issued per thread before their stores

template <typename I>
__device__ __forceinline__ int64_t aligned_start(const I* pos0, int64_t stride,
                                                 int64_t w, int64_t e,
                                                 int64_t j, int32_t* off) {
  const int64_t p = static_cast<int64_t>(pos0[w * stride]);  // >= 0
  const int64_t floor8 = p / 8 * 8;
  const int64_t hi = e - j > 0 ? e - j : 0;
  const int64_t a = floor8 < hi ? floor8 : hi;
  *off = static_cast<int32_t>(p - a);
  return a;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const T* __restrict__ y, const I* __restrict__ pos0,
                   int64_t pos_stride, T* __restrict__ out,
                   int32_t* __restrict__ off, int64_t e, int64_t row_units,
                   int64_t b, int64_t j) {
  const int64_t n = j * row_units;  // units per window
  for (int64_t w = blockIdx.x; w < b; w += gridDim.x) {
    int32_t o;
    const int64_t p0 = aligned_start(pos0, pos_stride, w, e, j, &o);
    if (threadIdx.x == 0) off[w] = o;
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

template <typename T, typename I>
void launch_units(const void* y, const void* pos0, int64_t pos_stride,
                  void* out, int32_t* off, int64_t e, int64_t row_bytes,
                  int64_t b, int64_t j, cudaStream_t stream) {
  const int64_t max_grid = 2147483647;
  const unsigned grid = static_cast<unsigned>(b < max_grid ? b : max_grid);
  window_rows_kernel<T, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const I*>(pos0), pos_stride,
      static_cast<T*>(out), off, e, row_bytes / static_cast<int64_t>(sizeof(T)),
      b, j);
}

// the widest unit that divides the row's bytes and both pointers
template <typename I>
void launch(const void* y, const void* pos0, int64_t pos_stride, void* out,
            int32_t* off, int64_t e, int64_t row_bytes, int64_t b, int64_t j,
            cudaStream_t s) {
  const uint64_t align = reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(out) |
                         static_cast<uint64_t>(row_bytes);
  if (align % 16 == 0) {
    launch_units<uint4, I>(y, pos0, pos_stride, out, off, e, row_bytes, b, j, s);
  } else if (align % 8 == 0) {
    launch_units<uint2, I>(y, pos0, pos_stride, out, off, e, row_bytes, b, j, s);
  } else if (align % 4 == 0) {
    launch_units<uint32_t, I>(y, pos0, pos_stride, out, off, e, row_bytes, b, j, s);
  } else if (align % 2 == 0) {
    launch_units<uint16_t, I>(y, pos0, pos_stride, out, off, e, row_bytes, b, j, s);
  } else {
    launch_units<uint8_t, I>(y, pos0, pos_stride, out, off, e, row_bytes, b, j, s);
  }
}

}  // namespace

// C interface for ctypes.  y: device pointer to a contiguous (e, row_bytes)
// byte table; pos0: device pointer to b window starts (int32 if pos_bytes is
// 4, int64 if 8), pos_stride elements apart; out: device pointer to a
// contiguous (b, j, row_bytes) byte array; off: device pointer to (b,)
// int32 offsets pos0 - p0a; stream: a cudaStream_t.  Launches one kernel.
// Returns cudaGetLastError().
extern "C" int ocn_window_rows(const void* y, const void* pos0,
                               int64_t pos_stride, int pos_bytes, void* out,
                               void* off, int64_t e, int64_t row_bytes,
                               int64_t b, int64_t j, void* stream) {
  if (b <= 0 || j <= 0 || row_bytes <= 0 || e <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(off);
  if (pos_bytes == 4) {
    launch<int32_t>(y, pos0, pos_stride, out, o, e, row_bytes, b, j, s);
  } else {
    launch<int64_t>(y, pos0, pos_stride, out, o, e, row_bytes, b, j, s);
  }
  return static_cast<int>(cudaGetLastError());
}
