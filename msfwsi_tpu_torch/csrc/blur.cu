// Separable per-sample 23-tap Gaussian blur for NHWC images, C = 3.
//
// Replaces the Pallas TPU kernel msfwsi_tpu/ops/pallas/blur.py
// (separable_blur_nhwc; pl.pallas_call in _vblur, body _vblur_kernel). That
// kernel makes one vertical pass per call and the wrapper runs it twice with
// H<->W transposes in device memory between; here one launch makes both
// passes. Reflect-101 borders, fp32 sums, the output in the input's type;
// taps beyond a sample's kernel size are zero, so one 23-tap loop serves
// every drawn size.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// for fp32 images, bytes: one read and one write of a (32,1024,1024,3) batch
// is 805 MB, 0.240 ms, against 0.138 ms for 2 x 23 fp32 FMAs per element.
// For bf16 images the bytes halve (0.120 ms) and the FMAs bound it.
//
// Design: one block per (sample, 32x32-pixel output tile), as in
// colorops.cu with the halo widened to 11. The block loads its 23 taps once,
// then its tile plus the halo, 54x54 pixels, into shared memory as fp32; the
// reflect-101 border comes from mirrored indices at load time, so no padded
// copy is made in device memory. The vertical pass writes a second shared
// tile (32x54 pixels), which the horizontal pass reads. The vertical result
// stays fp32 in shared memory, where the Pallas path rounds it to the image
// type between its two calls; for fp32 images nothing differs, for bf16 and
// fp16 the kernel is the more exact by up to half an ulp of the type.
//
// The shared-memory limit: the fp32 input tile (54x162 floats, 34,992 B) and
// the vertical tile (32x163 floats, 20,864 B) come to 55,856 B, over the
// 48 KB a static __shared__ array may take. The tiles are dynamic shared
// memory, allowed past 48 KB by cudaFuncSetAttribute before each launch; an
// error there is returned like a launch error. 4 blocks fit on an SM.
//
// Against the FMAs and shared-memory reads: each thread computes 8
// consecutive outputs of a pass from a 30-value window it reads once from
// shared memory (30 reads for 184 FMAs, where one read per FMA would make
// shared memory the limit). Vertical-pass threads of a warp read
// neighbouring columns; horizontal-pass threads read 32 rows of one column
// of an odd-pitched tile; both are free of bank conflicts. The horizontal
// results go to a staging tile (over the input tile, no longer needed) and
// leave in row order, so the stores to device memory are coalesced. The
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KTAPS = 23;
constexpr int HALF = KTAPS / 2;         // 11: the halo
constexpr int TILE = 32;                // output pixels per block side
constexpr int IN = TILE + 2 * HALF;     // 54: loaded pixels per block side
constexpr int C = 3;
constexpr int IN_PITCH = IN * C;        // 162 floats per input-tile row
constexpr int V_PITCH = IN * C + 1;     // 163: odd, for the horizontal pass
constexpr int O_PITCH = TILE * C + 1;   // 97: odd, for the staging tile
constexpr int R = 8;                    // outputs per thread per pass
constexpr int WIN = R + KTAPS - 1;      // 30: window a thread reads
constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = IN * IN_PITCH + TILE * V_PITCH;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);  // 55,856 B
static_assert(TILE % R == 0, "a thread's outputs stay inside the tile");
static_assert(TILE * O_PITCH <= IN * IN_PITCH, "the staging tile fits over the input tile");

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
// Valid for |overhang| <= n-1, so n >= 12 here; the clamp only touches halo
// pixels of a ragged edge tile that no stored output reads.
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// out[i] = sum_t k[t] * src[(i + t) * stride], i < R, sums in tap order.
__device__ __forceinline__ void taps_window(const float* src, int stride, const float (&k)[KTAPS],
                                            float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < WIN; ++j) {
    const float v = src[j * stride];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = j - i;
      if (t >= 0 && t < KTAPS) acc[i] = fmaf(k[t], v, acc[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
separable_blur_kernel(const T* __restrict__ img, T* __restrict__ out,
                      const float* __restrict__ taps, int H, int W) {
  extern __shared__ float smem[];
  float* tile = smem;                    // [IN][IN_PITCH]
  float* vert = smem + IN * IN_PITCH;    // [TILE][V_PITCH]
  float* stage = smem;                   // [TILE][O_PITCH], over tile
  __shared__ float k_s[KTAPS];

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const size_t base = (size_t)n * H * W * C;
  const T* src = img + base;
  T* dst = out + base;
  const int rows = min(TILE, H - y0);
  const int cols = min(TILE, W - x0);

  if (threadIdx.x < KTAPS) k_s[threadIdx.x] = taps[n * KTAPS + threadIdx.x];
  for (int e = threadIdx.x; e < IN * IN_PITCH; e += THREADS) {
    const int r = e / IN_PITCH;
    const int cc = e - r * IN_PITCH;
    const int px = cc / C;
    const int ch = cc - px * C;
    const int gy = reflect101(y0 - HALF + r, H);
    const int gx = reflect101(x0 - HALF + px, W);
    tile[e] = to_float(src[((size_t)gy * W + gx) * C + ch]);
  }
  __syncthreads();

  float k[KTAPS];
#pragma unroll
  for (int t = 0; t < KTAPS; ++t) k[t] = k_s[t];

  // Vertical pass: rows r0..r0+R-1 of one column of (pixel, channel).
  for (int task = threadIdx.x; task < (TILE / R) * IN_PITCH; task += THREADS) {
    const int r0 = (task / IN_PITCH) * R;
    const int cc = task - (r0 / R) * IN_PITCH;
    float acc[R];
    taps_window(tile + r0 * IN_PITCH + cc, IN_PITCH, k, acc);
#pragma unroll
    for (int i = 0; i < R; ++i) vert[(r0 + i) * V_PITCH + cc] = acc[i];
  }
  __syncthreads();

  // Horizontal pass: pixels px0..px0+R-1 of one channel of one row; the
  // lanes of a warp take 32 different rows.
  for (int task = threadIdx.x; task < TILE * C * (TILE / R); task += THREADS) {
    const int r = task % TILE;
    const int q = task / TILE;
    const int ch = q % C;
    const int px0 = (q / C) * R;
    float acc[R];
    taps_window(vert + r * V_PITCH + px0 * C + ch, C, k, acc);
#pragma unroll
    for (int i = 0; i < R; ++i) stage[r * O_PITCH + (px0 + i) * C + ch] = acc[i];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < TILE * TILE * C; e += THREADS) {
    const int r = e / (TILE * C);
    const int cc = e - r * (TILE * C);
    if (r < rows && cc < cols * C) {
      dst[((size_t)(y0 + r) * W + x0) * C + cc] = from_float<T>(stage[r * O_PITCH + cc]);
    }
  }
}

template <typename T>
int launch(const void* img, void* out, const void* taps, int N, int H, int W,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(separable_blur_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, N);
  separable_blur_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), static_cast<const float*>(taps), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the CUDA error of
// the shared-memory attribute or of the launch (0 = success); -1 for an
// unknown dtype code.
extern "C" int msfwsi_separable_blur_nhwc(const void* img, void* out, const void* taps, int N,
                                          int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(img, out, taps, N, H, W, s);
    case 1: return launch<__nv_bfloat16>(img, out, taps, N, H, W, s);
    case 2: return launch<__half>(img, out, taps, N, H, W, s);
    default: return -1;
  }
}
