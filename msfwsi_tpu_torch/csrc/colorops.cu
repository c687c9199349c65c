// Fused per-sample blur-OR-sharpen-OR-passthrough for NHWC images, C = 3.
//
// Replaces the Pallas TPU kernel msfwsi_tpu/ops/pallas/colorops.py
// (blur_or_sharpen_fused, body _kernel). Per sample an int32 selector picks
//   1 = separable 17-tap Gaussian blur, reflect-101 borders, fp32 sums;
//   2 = 3x3 sharpen, reflect-101 borders, clipped to [0, 1];
//   anything else = passthrough, bit for bit.
// The output has the input's type.
//
// Bound on an H100: memory. Each launch must read the image once and write
// it once (2 x 32*1024^2*3*2 B = 403 MB for the bf16 1024 px target pass,
// about 120 us at 3.35 TB/s); the blur's 68 fp32 flops per element come to
// less than that at 67 TFLOP/s.
//
// Design: one block per (sample, tile of TW x TH = 128 x 16 output pixels).
// The block reads its sample's selector once, so the whole block takes one
// branch and a sample pays only for the op it drew:
// - passthrough copies its tile, each thread issuing all its 16-byte loads
//   before its 16-byte stores;
// - blur loads its tile plus an 8-pixel halo in the image's type as whole
//   rows of 16-byte cp.async copies (stencil.cuh), fills the reflect-101
//   columns in shared memory, makes the vertical pass into an fp32 tile
//   (the halo columns included) and the horizontal pass into a staged
//   output tile, 8 outputs per thread from one window each (taps_window),
//   and stores the tile in coalesced 32-bit words;
// - sharpen loads the tile with a 1-pixel halo only, computes 8 rows per
//   thread from a 10x3 window and stores as blur does.
// The wide, short tile keeps the halo's share of the vertical pass low
// (16 of 144 columns) and its shared memory at 56 KB in bf16, so 4 blocks
// share an SM and overlap one another's loads and passes (tiles of 32x32,
// 64x32, 32x16 and 64x16 were slower; PERF.md). Where the image's
// rows do not start on 16-byte boundaries (``vec`` 0) the same steps move
// single elements. The kernel allocates nothing and launches on the
// caller's stream.

#include "stencil.cuh"

namespace {

using namespace stencil;

constexpr int KTAPS = 17;
constexpr int HALF = KTAPS / 2;  // 8: the blur's halo
constexpr int R = 8;             // outputs per thread per pass

// Shared-memory layout of a tile of TW x TH output pixels with the blur's
// halo, for image type T.
template <typename T>
struct Tile {
  static constexpr int TW = 128;                       // output pixels across
  static constexpr int TH = 16;                        // and down
  static constexpr int V = 16 / sizeof(T);             // elements per 16 bytes
  static constexpr int ROWS = TH + 2 * HALF;           // loaded rows
  static constexpr int SPAN = (TW + 2 * HALF) * C;     // elements of a row with its halo
  // A row of the input tile holds the 16-byte-aligned superset of its span.
  static constexpr int PITCH = round_up(SPAN + 2 * (V - 1), V);
  static constexpr int V_PITCH = SPAN | 1;             // fp32 vertical-pass rows, odd
  // Staged output rows in T: an odd number of 32-bit words per row, so the
  // horizontal pass (one row per lane) writes without bank conflicts.
  static constexpr int O_PITCH = sizeof(T) == 4 ? TW * C + 1 : TW * C + 2;
  static constexpr int IN_BYTES = round_up(ROWS * PITCH * (int)sizeof(T), 16);
  static constexpr int VERT_BYTES = TH * V_PITCH * 4;
  static constexpr int SMEM_BYTES = IN_BYTES + VERT_BYTES;
  static_assert(TH * O_PITCH * (int)sizeof(T) <= IN_BYTES, "staging fits over the input tile");
  static_assert(TH * O_PITCH * (int)sizeof(T) <= VERT_BYTES, "staging fits over the vertical tile");
  static_assert((TW * C * (int)sizeof(T)) % 16 == 0, "tile columns start on 16-byte boundaries");
  static_assert(((O_PITCH * (int)sizeof(T) / 4) & 1) == 1, "odd staging pitch in words");
};

// The tile plus a halo of hh: rows y0-hh .. y0+TH+hh-1 (issue_rows and
// finish_rows in one). Returns the column of pixel x0-hh.
template <typename L, typename T>
__device__ __forceinline__ int load_tile(T* s, const T* __restrict__ src, int H, int W, int y0,
                                         int x0, int hh, bool vec) {
  issue_rows<L>(s, src, H, W, y0 - hh, L::TH + 2 * hh, x0, hh, vec);
  return finish_rows<L>(s, W, L::TH + 2 * hh, x0, hh, vec);
}

// Vertical pass: vert[r][j] = sum_t k[t] * s[r + t][col0 + j] for the TH
// output rows and all L::SPAN columns (the halo columns included).
template <typename L, int KT, int R, typename T>
__device__ __forceinline__ void vpass(const T* s, int col0, float* vert, const float (&k)[KT]) {
  static_assert(L::TH % R == 0, "a thread's rows stay inside the tile");
  constexpr int TASKS = (L::TH / R) * L::SPAN;
  for (int task = threadIdx.x; task < TASKS; task += THREADS) {
    const int rg = task / L::SPAN;  // by a constant: a multiply, not a division
    const int j = task - rg * L::SPAN;
    float acc[R];
    taps_window<KT, R>(s + rg * R * L::PITCH + col0 + j, L::PITCH, k, acc);
#pragma unroll
    for (int i = 0; i < R; ++i) vert[(rg * R + i) * L::V_PITCH + j] = acc[i];
  }
}

// Horizontal pass: stage[r][x*C+c] = sum_t k[t] * vert[r][(x+t)*C + c] for
// the TW x TH outputs, in T. The lanes of a warp take different rows of one
// (channel, pixel group), which the odd pitches keep free of bank conflicts.
template <typename L, int KT, int R, typename T>
__device__ __forceinline__ void hpass(const float* vert, T* stage, const float (&k)[KT]) {
  static_assert(L::TW % R == 0, "a thread's pixels stay inside the tile");
  constexpr int TASKS = L::TH * C * (L::TW / R);
  for (int task = threadIdx.x; task < TASKS; task += THREADS) {
    const int r = task % L::TH;
    const int q = task / L::TH;
    const int c = q % C;
    const int x = (q / C) * R;
    float acc[R];
    taps_window<KT, R>(vert + r * L::V_PITCH + x * C + c, C, k, acc);
#pragma unroll
    for (int i = 0; i < R; ++i) stage[r * L::O_PITCH + (x + i) * C + c] = from_float<T>(acc[i]);
  }
}

// Writes the staged tile (rows x cols pixels, stage pitch L::O_PITCH) to
// the sample ``dst`` at (y0, x0). With ``vec`` each row goes out as 32-bit
// words, lanes on consecutive words: the staged rows are read without bank
// conflicts and the stores are coalesced (a row starts on a 16-byte
// boundary, and a staged row on a 4-byte one); a 16-bit row of odd length
// ends with one element. Without ``vec``, element by element.
template <typename L, typename T>
__device__ __forceinline__ void store_tile(const T* stage, T* __restrict__ dst, int W, int y0,
                                           int x0, int rows, int cols, bool vec) {
  constexpr int E = 4 / sizeof(T);  // elements per word
  static_assert((L::O_PITCH * sizeof(T)) % 4 == 0, "staged rows start on 4-byte boundaries");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = cols * C;
  const int nw = vec ? len / E : 0;
  for (int r = warp; r < rows; r += WARPS) {
    T* g = dst + ((size_t)(y0 + r) * W + x0) * C;
    const T* s = stage + r * L::O_PITCH;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(s);
    uint32_t* gw = reinterpret_cast<uint32_t*>(g);
    for (int q = lane; q < nw; q += 32) gw[q] = sw[q];
    for (int u = nw * E + lane; u < len; u += 32) g[u] = s[u];
  }
}

// Passthrough: the rows x cols tile at (y0, x0) from ``src`` to ``dst``,
// bit for bit. With ``vec`` each thread issues all its 16-byte loads (PER
// of them) before its stores, so a tile's bytes are in flight at once; a
// ragged row's tail goes element by element.
template <typename L, typename T>
__device__ __forceinline__ void copy_tile(const T* __restrict__ src, T* __restrict__ dst, int W,
                                          int y0, int x0, int rows, int cols, bool vec) {
  constexpr int CPR = L::TW * C / L::V;  // 16-byte chunks in a full tile row
  constexpr int PER = (L::TH * CPR + THREADS - 1) / THREADS;
  const int len = cols * C;
  const int nvec = vec ? len / L::V : 0;
  if (vec) {
    uint4 v[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * THREADS;
      const int r = e / CPR, q = e - r * CPR;
      if (r < rows && q < nvec)
        v[p] = __ldg(reinterpret_cast<const uint4*>(src + ((size_t)(y0 + r) * W + x0) * C) + q);
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * THREADS;
      const int r = e / CPR, q = e - r * CPR;
      if (r < rows && q < nvec)
        reinterpret_cast<uint4*>(dst + ((size_t)(y0 + r) * W + x0) * C)[q] = v[p];
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += WARPS) {
    const size_t off = ((size_t)(y0 + r) * W + x0) * C;
    for (int u = nvec * L::V + lane; u < len; u += 32) dst[off + u] = src[off + u];
  }
}

// sharpen: out[r][u] = clip(sum_{dy,dx} k[dy][dx] * s[r+dy][col0 + u + dx*C])
// for the tile's TH rows and TW*C element columns, R rows per thread, sums
// in (dy, dx) order.
template <typename L, typename T>
__device__ __forceinline__ void sharpen_pass(const T* s, int col0, T* stage, const float (&k)[9]) {
  constexpr int COLS = L::TW * C;
  constexpr int TASKS = (L::TH / R) * COLS;
  for (int task = threadIdx.x; task < TASKS; task += THREADS) {
    const int rg = task / COLS;
    const int u = task - rg * COLS;
    const T* w = s + rg * R * L::PITCH + col0 + u;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < R + 2; ++j) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float v = to_float(w[j * L::PITCH + dx * C]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int dy = j - i;
          if (dy >= 0 && dy < 3) acc[i] = fmaf(k[dy * 3 + dx], v, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      stage[(rg * R + i) * L::O_PITCH + u] = from_float<T>(fminf(fmaxf(acc[i], 0.f), 1.f));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blur_or_sharpen_kernel(const T* __restrict__ img, T* __restrict__ out,
                       const float* __restrict__ taps, const float* __restrict__ sharp,
                       const int* __restrict__ sel, int H, int W, int vec) {
  using L = Tile<T>;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * L::TH;
  const int x0 = blockIdx.x * L::TW;
  const size_t base = (size_t)n * H * W * C;
  const T* src = img + base;
  T* dst = out + base;
  const int op = sel[n];
  const int rows = min(L::TH, H - y0);
  const int cols = min(L::TW, W - x0);
  const bool v = vec != 0;

  if (op != 1 && op != 2) {
    copy_tile<L>(src, dst, W, y0, x0, rows, cols, v);
    return;  // the whole block took this branch: no barrier is skipped by part of it
  }

  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem);
  float* vert = reinterpret_cast<float*>(smem + L::IN_BYTES);

  if (op == 1) {
    const int col0 = load_tile<L>(in, src, H, W, y0, x0, HALF, v);
    float k[KTAPS];
    load_taps(k, taps + n * KTAPS);
    vpass<L, KTAPS, R>(in, col0, vert, k);
    __syncthreads();
    hpass<L, KTAPS, R>(vert, in, k);  // staged over the input tile, no longer read
    __syncthreads();
    store_tile<L>(in, dst, W, y0, x0, rows, cols, v);
  } else {
    const int col0 = load_tile<L>(in, src, H, W, y0, x0, 1, v);
    float k[9];
    load_taps(k, sharp + n * 9);
    T* stage = reinterpret_cast<T*>(vert);  // sharpen needs no vertical tile
    sharpen_pass<L>(in, col0, stage, k);
    __syncthreads();
    store_tile<L>(stage, dst, W, y0, x0, rows, cols, v);
  }
}

template <typename T>
int launch(const void* img, void* out, const void* taps, const void* sharp, const void* sel,
           int N, int H, int W, int vec, cudaStream_t stream) {
  using L = Tile<T>;
  auto kernel = blur_or_sharpen_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + L::TW - 1) / L::TW, (H + L::TH - 1) / L::TH, N);
  kernel<<<grid, THREADS, L::SMEM_BYTES, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), static_cast<const float*>(taps),
      static_cast<const float*>(sharp), static_cast<const int*>(sel), H, W, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; vec: 1 if img and out
// start on 16-byte boundaries and a row's bytes (W*3*size) are a multiple
// of 16, else 0 (ops/cuda/colorops.py, launch_plan). Returns the CUDA error
// of the shared-memory attribute or of the launch (0 = success); -1 for an
// unknown dtype code.
extern "C" int msfwsi_blur_or_sharpen_fused(const void* img, void* out, const void* taps,
                                            const void* sharp, const void* sel, int N, int H,
                                            int W, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(img, out, taps, sharp, sel, N, H, W, vec, s);
    case 1: return launch<__nv_bfloat16>(img, out, taps, sharp, sel, N, H, W, vec, s);
    case 2: return launch<__half>(img, out, taps, sharp, sel, N, H, W, vec, s);
    default: return -1;
  }
}
