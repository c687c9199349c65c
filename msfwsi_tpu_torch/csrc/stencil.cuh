// Shared pieces of the two reflect-101 stencils over NHWC images with C = 3:
// the blur-or-sharpen kernel (colorops.cu, tiles) and the standalone blur
// (blur.cu, column strips).
//
// A block of either kernel works on a run of image rows that it copies into
// shared memory in the image's own type:
//
//   issue_rows   starts the copies. A row of a tile or strip plus its halo
//                is one run of (width + 2h) * 3 elements in NHWC; when every
//                image row starts on a 16-byte boundary (``vec``), the
//                run's 16-byte-aligned superset goes as 16-byte cp.async
//                copies, which land while the block computes; otherwise
//                element by element. Only the part inside the image is
//                read; rows above and below come from mirrored row indices.
//   finish_rows  waits for them, then fills the halo columns outside the
//                image, inside shared memory, from the row's own pixels
//                1..h (reflect-101).
//
// taps_window is the register-blocked 1-D pass: R consecutive outputs from
// one window of R + KT - 1 values read once, fp32 sums in tap order.
//
// Every loop over rows gives one warp one row, so no thread divides by a
// run-time value to find its row. Nothing here allocates or synchronises
// beyond the block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stencil {

constexpr int C = 3;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// Reflect-101 (cv2 BORDER_REFLECT_101, numpy "reflect"): -1 -> 1, n -> n-2.
// Valid for |overhang| <= n-1; the clamp only touches rows past a ragged
// edge that no stored output reads.
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Element of an image row held in column 0 of an input buffer:
// (x0-hh)*C, rounded down to 16 bytes where ``vec``.
__device__ __forceinline__ int first_column(int x0, int hh, int V, bool vec) {
  const int u_lo = (x0 - hh) * C;
  return vec ? (u_lo & ~(V - 1)) : u_lo;  // & floors negatives too
}

// Starts copying image rows reflect101(y_first + r), r < nrows, pixels
// x0-hh .. x0+L::TW+hh-1, of the sample ``src`` (H x W x C) into the rows of
// ``s`` (L: the kernel's layout, with TW, V and PITCH, the row pitch in
// elements of T); column j of ``s`` holds element first_column() + j of
// its row. Only the part inside the image is read.
// With ``vec`` the copies are cp.async, committed as one group; without,
// they are done when this returns (for this thread).
template <typename L, typename T>
__device__ __forceinline__ void issue_rows(T* s, const T* __restrict__ src, int H, int W,
                                           int y_first, int nrows, int x0, int hh, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u0 = first_column(x0, hh, L::V, vec);
  const int a = max(u0, 0), b = min((x0 + L::TW + hh) * C, W * C);
  const size_t row_elems = (size_t)W * C;
  if (vec) {
    // a is 16-byte aligned (0 or u0); W*C is a multiple of V, so rounding
    // b up stays inside the row.
    const int chunks = (min(round_up(b, L::V), W * C) - a) / L::V;
    for (int r = warp; r < nrows; r += WARPS) {
      const T* g = src + (size_t)reflect101(y_first + r, H) * row_elems + a;
      T* d = s + r * L::PITCH + (a - u0);
      for (int q = lane; q < chunks; q += 32) cp_async16(d + q * L::V, g + q * L::V);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int r = warp; r < nrows; r += WARPS) {
      const T* g = src + (size_t)reflect101(y_first + r, H) * row_elems;
      T* d = s + r * L::PITCH - u0;
      for (int u = a + lane; u < b; u += 32) d[u] = g[u];
    }
  }
}

// Waits for the copies of issue_rows (the only group in flight), then fills
// the halo columns outside the image in the nrows rows of ``s``. Returns
// the column of pixel x0-hh. Ends at a barrier.
template <typename L, typename T>
__device__ __forceinline__ int finish_rows(T* s, int W, int nrows, int x0, int hh, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u_lo = (x0 - hh) * C, u_hi = (x0 + L::TW + hh) * C;
  const int u0 = first_column(x0, hh, L::V, vec);
  const int a = max(u0, 0), b = min(u_hi, W * C);
  if (vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // Pixel x < 0 takes pixel -x, pixel x >= W takes 2W-2-x; both lie in the
  // loaded part [a, b) for every pixel a stored output reads (W > hh).
  // Further pixels of a ragged edge are clamped into it and read by no
  // stored output.
  const int left = max(0, -u_lo), right = max(0, u_hi - W * C);
  if (left + right > 0) {  // uniform across the block
    const int lo_px = (a + C - 1) / C, hi_px = b / C - 1;  // whole pixels loaded
    for (int r = warp; r < nrows; r += WARPS) {
      T* d = s + r * L::PITCH - u0;
      for (int e = lane; e < left + right; e += 32) {
        const int u = e < left ? u_lo + e : W * C + (e - left);
        const int x = (u + C * hh) / C - hh;  // floor(u / C) for u >= -C*hh
        const int c = u - x * C;
        int xs = x < 0 ? -x : 2 * W - 2 - x;
        xs = min(max(xs, lo_px), hi_px);
        d[u] = d[xs * C + c];
      }
    }
    __syncthreads();
  }
  return u_lo - u0;
}

template <int KT>
__device__ __forceinline__ void load_taps(float (&k)[KT], const float* __restrict__ p) {
#pragma unroll
  for (int t = 0; t < KT; ++t) k[t] = p[t];
}

// acc[i] = sum_t k[t] * src[(i + t) * stride], i < R, fp32 sums in tap
// order; each of the R + KT - 1 window values is read once.
template <int KT, int R, typename S>
__device__ __forceinline__ void taps_window(const S* src, int stride, const float (&k)[KT],
                                            float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < R + KT - 1; ++j) {
    const float v = to_float(src[j * stride]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = j - i;
      if (t >= 0 && t < KT) acc[i] = fmaf(k[t], v, acc[i]);
    }
  }
}

}  // namespace stencil
