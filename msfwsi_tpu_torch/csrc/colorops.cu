// Fused per-sample blur-OR-sharpen-OR-passthrough for NHWC images, C = 3.
//
// Replaces the Pallas TPU kernel msfwsi_tpu/ops/pallas/colorops.py
// (blur_or_sharpen_fused, body _kernel). Per sample an int32 selector picks
//   1 = separable 17-tap Gaussian blur, reflect-101 borders, fp32 sums;
//   2 = 3x3 sharpen, reflect-101 borders, clipped to [0, 1];
//   anything else = passthrough.
// The output has the input's type.
//
// Bound on an H100: memory. Each launch must read the image once and write
// it once (2 x 32*1024^2*3*2 B = 403 MB for the bf16 1024 px target pass,
// about 120 us at 3.35 TB/s); the blur's 68 fp32 flops per element come to
// less than that at 67 TFLOP/s.
//
// Design: one block per (sample, 32x32-pixel output tile). The block reads
// its sample's selector, so the whole block takes one branch and a sample
// pays only for the op it drew. For blur and sharpen the block loads its
// tile plus an 8-pixel halo into shared memory, converted to fp32; the
// reflect-101 border comes from mirrored indices at load time, so no padded
// copy is made in device memory. The vertical blur pass writes a second
// shared tile, the horizontal pass reads it and stores the output. Sharpen
// reads its 1-pixel neighbourhood from the same loaded tile. Passthrough
// copies. The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KTAPS = 17;
constexpr int HALF = KTAPS / 2;       // 8: the blur's halo
constexpr int TILE = 32;              // output pixels per block side
constexpr int IN = TILE + 2 * HALF;   // 48: loaded pixels per block side
constexpr int C = 3;
constexpr int THREADS = 256;

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
// Valid for |overhang| <= n-1; the clamp only touches halo pixels of a
// ragged edge tile that no stored output reads.
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blur_or_sharpen_kernel(const T* __restrict__ img, T* __restrict__ out,
                       const float* __restrict__ taps, const float* __restrict__ sharp,
                       const int* __restrict__ sel, int H, int W) {
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const size_t base = (size_t)n * H * W * C;
  const T* src = img + base;
  T* dst = out + base;
  const int op = sel[n];
  const int rows = min(TILE, H - y0);
  const int cols = min(TILE, W - x0);

  if (op != 1 && op != 2) {
    for (int e = threadIdx.x; e < TILE * TILE * C; e += THREADS) {
      const int r = e / (TILE * C);
      const int rem = e - r * (TILE * C);
      if (r < rows && rem < cols * C) {
        const size_t off = ((size_t)(y0 + r) * W + x0) * C + rem;
        dst[off] = src[off];
      }
    }
    return;  // the whole block took this branch: no barrier is skipped by part of it
  }

  __shared__ float tile[IN][IN * C];    // 27,648 B
  __shared__ float vert[TILE][IN * C];  // 18,432 B

  for (int e = threadIdx.x; e < IN * IN * C; e += THREADS) {
    const int r = e / (IN * C);
    const int cc = e - r * (IN * C);
    const int px = cc / C;
    const int ch = cc - px * C;
    const int gy = reflect101(y0 - HALF + r, H);
    const int gx = reflect101(x0 - HALF + px, W);
    tile[r][cc] = to_float(src[((size_t)gy * W + gx) * C + ch]);
  }
  __syncthreads();

  if (op == 1) {
    float k[KTAPS];
#pragma unroll
    for (int u = 0; u < KTAPS; ++u) k[u] = taps[n * KTAPS + u];
    for (int e = threadIdx.x; e < TILE * IN * C; e += THREADS) {
      const int r = e / (IN * C);
      const int cc = e - r * (IN * C);
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < KTAPS; ++u) acc += k[u] * tile[r + u][cc];
      vert[r][cc] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * TILE * C; e += THREADS) {
      const int r = e / (TILE * C);
      const int rem = e - r * (TILE * C);
      if (r < rows && rem < cols * C) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < KTAPS; ++u) acc += k[u] * vert[r][rem + u * C];
        dst[((size_t)(y0 + r) * W + x0) * C + rem] = from_float<T>(acc);
      }
    }
  } else {
    float k[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) k[i] = sharp[n * 9 + i];
    for (int e = threadIdx.x; e < TILE * TILE * C; e += THREADS) {
      const int r = e / (TILE * C);
      const int rem = e - r * (TILE * C);
      if (r < rows && rem < cols * C) {
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc += k[dy * 3 + dx] * tile[r + HALF - 1 + dy][rem + (HALF - 1 + dx) * C];
        acc = fminf(fmaxf(acc, 0.f), 1.f);
        dst[((size_t)(y0 + r) * W + x0) * C + rem] = from_float<T>(acc);
      }
    }
  }
}

template <typename T>
int launch(const void* img, void* out, const void* taps, const void* sharp, const void* sel,
           int N, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, N);
  blur_or_sharpen_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), static_cast<const float*>(taps),
      static_cast<const float*>(sharp), static_cast<const int*>(sel), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after the launch (0 = success); -1 for an unknown dtype code.
extern "C" int msfwsi_blur_or_sharpen_fused(const void* img, void* out, const void* taps,
                                            const void* sharp, const void* sel, int N, int H,
                                            int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(img, out, taps, sharp, sel, N, H, W, s);
    case 1: return launch<__nv_bfloat16>(img, out, taps, sharp, sel, N, H, W, s);
    case 2: return launch<__half>(img, out, taps, sharp, sel, N, H, W, s);
    default: return -1;
  }
}
