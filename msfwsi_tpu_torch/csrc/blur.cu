// Separable per-sample 23-tap Gaussian blur for NHWC images, C = 3.
//
// Replaces the Pallas TPU kernel msfwsi_tpu/ops/pallas/blur.py
// (separable_blur_nhwc; pl.pallas_call in _vblur, body _vblur_kernel). That
// kernel makes one vertical pass per call and the wrapper runs it twice with
// H<->W transposes in device memory between; here one launch makes both
// passes. Reflect-101 borders, fp32 sums in tap order, the output in the
// input's type; taps beyond a sample's kernel size are zero, so one 23-tap
// loop serves every drawn size. The horizontal pass runs first and its
// result stays fp32 in shared memory, where the Pallas path makes the
// vertical pass first and rounds it to the image type between its two
// calls: for fp32 images the two orders differ by rounding (up to 4.2e-7
// on the smoke's images), for bf16 and fp16 the kernel is the more
// exact by up to half an ulp of the type.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// for fp32 images, bytes: one read and one write of a (32,1024,1024,3) batch
// is 805 MB, 0.240 ms, against 0.138 ms for 2 x 23 fp32 FMAs per element.
// For bf16 images the bytes halve (0.120 ms) and the FMAs bound it.
//
// Design: one block per (sample, column strip SW = 80 pixels wide and
// 23 * chunks rows tall; the wrapper picks chunks by shape). The block walks
// down its strip 23 rows at a time:
// - the rows come in as whole rows of 16-byte cp.async copies, the
//   reflect-101 columns filled in shared memory (stencil.cuh); the next 23
//   rows are copied while the current ones are computed;
// - the horizontal pass, 8 outputs per thread from one window of 30 values
//   (taps_window), writes each row once into an fp32 buffer;
// - the vertical pass gives each output column one thread with a window of
//   23 registers that rotates down the strip: one shared-memory read and 23
//   FMAs per output, and the warp stores a row's consecutive elements.
// So every input row is loaded once (plus 22 halo rows per strip, where a
// 32x32 tile loads 2.85x its pixels), the vertical pass has no halo
// columns, and no output is staged. Where the image's rows do not
// start on 16-byte boundaries (``vec`` 0) the rows come element by element.
// Shared memory is dynamic (52 KB in fp32, 37 KB in bf16), allowed by
// cudaFuncSetAttribute before each launch; an error there is returned like
// a launch error. The kernel allocates nothing and launches on the caller's
// stream.

#include "stencil.cuh"

namespace {

using namespace stencil;

constexpr int KTAPS = 23;
constexpr int HALF = KTAPS / 2;  // 11: the halo
constexpr int R = 8;             // outputs per thread of the horizontal pass
constexpr int SW = 80;           // output pixels of a strip, across

// Shared-memory layout of a column strip SW pixels wide, walked down in
// chunks of KTAPS rows, for image type T.
template <typename T>
struct Strip {
  static constexpr int TW = SW;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int ROWS = KTAPS;                // input rows per chunk
  static constexpr int SPAN = (TW + 2 * HALF) * C;  // elements of a row with its halo
  static constexpr int COLS = TW * C;               // output elements of a row
  // Input rows: 16-byte multiples for cp.async, and 16 bytes past a multiple
  // of 128, so that the horizontal pass's lanes, one row each, meet 8
  // different groups of banks (at a multiple of 128 bytes all rows start in
  // the same bank: 23-way conflicts, 3.7x slower in bf16).
  static constexpr int PITCH =
      (round_up(round_up(SPAN + 2 * (V - 1), V) * (int)sizeof(T) - 16, 128) + 16) / (int)sizeof(T);
  static constexpr int H_PITCH = COLS | 1;           // fp32 rows after the horizontal pass, odd
  static constexpr int IN_BYTES = round_up(ROWS * PITCH * (int)sizeof(T), 16);
  static constexpr int SMEM_BYTES = IN_BYTES + ROWS * H_PITCH * 4;
  static_assert(COLS <= THREADS, "one thread per output column");
};

// Horizontal pass over the ROWS rows of the input buffer: hor[r][x*C+c] =
// sum_t k[t] * s[r][col0 + (x+t)*C + c], R_ pixels per thread, the lanes of
// a warp on different rows (the odd pitch of ``hor`` keeps its writes free
// of bank conflicts).
template <typename L, int KT, int R_, typename T>
__device__ __forceinline__ void hpass_rows(const T* s, int col0, float* hor,
                                           const float (&k)[KT]) {
  static_assert(L::TW % R_ == 0, "a thread's pixels stay inside the strip");
  constexpr int TASKS = L::ROWS * C * (L::TW / R_);
  for (int task = threadIdx.x; task < TASKS; task += THREADS) {
    const int r = task % L::ROWS;
    const int q = task / L::ROWS;
    const int c = q % C;
    const int x = (q / C) * R_;
    float acc[R_];
    taps_window<KT, R_>(s + r * L::PITCH + col0 + x * C + c, C, k, acc);
#pragma unroll
    for (int i = 0; i < R_; ++i) hor[r * L::H_PITCH + (x + i) * C + c] = acc[i];
  }
}

// One block per (sample, strip of SW pixels x KTAPS*chunks rows). Horizontal
// pass first, on each input row once; then the vertical pass with a window
// of KTAPS registers per output column that rotates down the strip: each
// output takes one shared-memory read and KTAPS FMAs, and a warp stores a
// row's consecutive elements. Input row i of the strip is image row
// ys - HALF + i; output row o takes rows o .. o + KTAPS-1. The next chunk's
// rows are copied in while the current chunk's vertical pass runs.
template <typename T>
__global__ void __launch_bounds__(THREADS)
strip_blur_kernel(const T* __restrict__ img, T* __restrict__ out,
                  const float* __restrict__ taps, int H, int W, int strip_chunks, int vec) {
  using L = Strip<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem);
  float* hor = reinterpret_cast<float*>(smem + L::IN_BYTES);
  const int n = blockIdx.z;
  const int ys = blockIdx.y * KTAPS * strip_chunks;
  const int x0 = blockIdx.x * SW;
  const size_t base = (size_t)n * H * W * C;
  const T* src = img + base;
  const bool v = vec != 0;
  const int rows_out = min(KTAPS * strip_chunks, H - ys);
  const int chunks = (rows_out + KTAPS - 1) / KTAPS;
  const int len = min(SW, W - x0) * C;
  const int j = threadIdx.x;
  float k[KTAPS];
  load_taps(k, taps + n * KTAPS);

  // Rows 0 .. KTAPS-2 of the strip, the window's first values.
  issue_rows<L>(in, src, H, W, ys - HALF, KTAPS - 1, x0, HALF, v);
  int col0 = finish_rows<L>(in, W, KTAPS - 1, x0, HALF, v);
  hpass_rows<L, KTAPS, R>(in, col0, hor, k);  // its last row is not read
  __syncthreads();
  float w[KTAPS];  // w[i % KTAPS] holds input row i
  if (j < L::COLS) {
#pragma unroll
    for (int u = 0; u < KTAPS - 1; ++u) w[u] = hor[u * L::H_PITCH + j];
  }
  issue_rows<L>(in, src, H, W, ys + HALF, KTAPS, x0, HALF, v);
  T* o = out + base + ((size_t)ys * W + x0) * C + j;
  for (int c = 0; c < chunks; ++c) {
    // Rows KTAPS-1 + KTAPS*c + s, s < KTAPS: output rows KTAPS*c + s.
    col0 = finish_rows<L>(in, W, KTAPS, x0, HALF, v);
    hpass_rows<L, KTAPS, R>(in, col0, hor, k);
    __syncthreads();
    if (c + 1 < chunks)
      issue_rows<L>(in, src, H, W, ys + HALF + KTAPS * (c + 1), KTAPS, x0, HALF, v);
    if (j < L::COLS) {
#pragma unroll
      for (int s = 0; s < KTAPS; ++s) {
        w[(KTAPS - 1 + s) % KTAPS] = hor[s * L::H_PITCH + j];
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < KTAPS; ++t) acc = fmaf(k[t], w[(s + t) % KTAPS], acc);
        if (j < len && KTAPS * c + s < rows_out) o[0] = from_float<T>(acc);
        o += (size_t)W * C;
      }
    }
  }
}

template <typename T>
int launch(const void* img, void* out, const void* taps, int N, int H, int W, int chunks,
           int vec, cudaStream_t stream) {
  using L = Strip<T>;
  auto kernel = strip_blur_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + SW - 1) / SW, (H + KTAPS * chunks - 1) / (KTAPS * chunks), N);
  kernel<<<grid, THREADS, L::SMEM_BYTES, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), static_cast<const float*>(taps), H, W,
      chunks, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; chunks: the strip's height
// in chunks of 23 rows, > 0; vec: 1 if img and out start on 16-byte
// boundaries and a row's bytes (W*3*size) are a multiple of 16, else 0 (both
// from ops/cuda/blur.py, launch_plan). Returns the CUDA error of the
// shared-memory attribute or of the launch (0 = success); -1 for an unknown
// dtype code or chunks < 1.
extern "C" int msfwsi_separable_blur_nhwc(const void* img, void* out, const void* taps, int N,
                                          int H, int W, int dtype, int chunks, int vec,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks < 1) return -1;
  switch (dtype) {
    case 0: return launch<float>(img, out, taps, N, H, W, chunks, vec, s);
    case 1: return launch<__nv_bfloat16>(img, out, taps, N, H, W, chunks, vec, s);
    case 2: return launch<__half>(img, out, taps, N, H, W, chunks, vec, s);
    default: return -1;
  }
}
