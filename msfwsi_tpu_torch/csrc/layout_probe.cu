// Layout probe kernels: gathers along H and W of an NHWC bf16 array, with
// an elementwise op on top.
//
// Replaces the Pallas TPU kernels of tools/diag/mosaic_probe.py,
// mosaic_probe2.py and mosaic_probe3.py (the pl.pallas_call in each
// try_one, 20 bodies in all): probes of strided slices, offset windows,
// reshapes, tiles, element repeats, rolls, an interleaving store, neighbour
// max and selects, the pieces of a max-pool backward. Each body is one
// launch of one of four ops here:
//   COPY           out = A
//   MAX            out = max(A, B)           (NaN wins, as jnp.maximum)
//   NEGATE_ODD_W   out = w even ? A : -A
//   KEEP_POSITIVE  out = A > 0 ? A : 0 * A   (a negative A gives -0.0)
// where A and B are gathers of the input, out[n,h,w,c] = x[n, mh(h), mw(w),
// c], through one index map per axis,
//   m(i) = (off + i * num / den) % mod + (i % 2) * alt,
// which covers stride 2 (num 2), offset windows (off), element repeat
// (den 2), tile (mod n), roll by s (off n - s, mod n) and the interleaving
// store (den 2, alt 64). A reshape that keeps the memory order is a COPY of
// the input viewed in the output's shape. Channels are never remapped; the
// output may keep the first Cout of Cin channels.
//
// Bound on an H100: bytes. Every case reads each input element it needs
// once and writes each output element once, 16.8 MB each way for a
// (8,128,128,64) bf16 array, about 0.010 ms at 3.35 TB/s; the ops are one
// compare per element at most.
//
// Design. The work is moved as 16-byte vectors of 8 channels (C is a
// multiple of 8). One block covers one output row (n, h), or a chunk of a
// row longer than 512 threads times 4 vectors: the row's h maps are
// block-uniform scalars, and the threads cover (w, channel vector) with
// neighbouring threads on neighbouring addresses. Nothing divides at run
// time per vector: the wrapper hands each map over as
//   m(i) = off + ((i * num) >> shift), less mod once if >= mod, + (i & 1) * alt
// (den a power of two, every off + i * num / den below 2 * mod, which the
// wrapper checks), and the channel vectors per pixel as a power of two, so
// a vector index splits into (w, cv) by a shift and a mask. Each thread
// moves 4 vectors and starts all their loads (read-only path) before it
// uses any; the outputs are stored evict-first, as nothing here reads them
// again. For a max of two gathers of one row, the second gather's lines
// come from L1 or L2: staging the row in shared memory first gained at
// most 3% on the card, too little to keep. The ops work on the bf16 bit
// patterns: copies and selects move bits, negation flips the sign bit, MAX
// compares two values at once as bf16x2, KEEP_POSITIVE through fp32, so
// the results are exact. The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

struct ProbeMap {
  int off, num, shift, mod, alt;
};

struct ProbeGather {
  ProbeMap h, w;
};

// One launch's arguments but the pointers and the stream, built once by the
// wrapper for each (input shape, op, output shape, gathers).
struct ProbeLaunch {
  int op, N, Hin, Win, CinV, Hout, Wout, cv_bits, threads;
  ProbeGather a, b;
};

namespace {

constexpr int MAX_THREADS = 512;
constexpr int VPT = 4;  // 16-byte vectors a thread

enum Op { COPY = 0, MAX = 1, NEGATE_ODD_W = 2, KEEP_POSITIVE = 3 };

__device__ __forceinline__ int map_index(const ProbeMap& m, int i) {
  int j = m.off + ((i * m.num) >> m.shift);
  j -= j >= m.mod ? m.mod : 0;
  return j + (i & 1) * m.alt;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// One bf16 value (the low 16 bits of a) through the op.
template <int OP>
__device__ __forceinline__ uint32_t apply_one(uint32_t a, bool odd_w) {
  if (OP == COPY) return a;
  if (OP == NEGATE_ODD_W) return odd_w ? a ^ 0x8000u : a;
  const float fa = bf16_bits_to_float(a);  // KEEP_POSITIVE
  return (fa > 0.f || fa != fa) ? a : (a & 0x8000u);
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, sizeof(h));
  return h;
}

// Two bf16 values packed in a 32-bit word. MAX compares both halves at once
// (bf16x2 compares, exact: no rounding, subnormals kept) and takes each
// half of a where a is NaN or a >= b, else of b: NaN wins, a first, as the
// element-wise rule isnan(a) ? a : isnan(b) ? b : a >= b ? a : b.
template <int OP>
__device__ __forceinline__ uint32_t apply_pair(uint32_t a, uint32_t b, bool odd_w) {
  if constexpr (OP == MAX) {
    const __nv_bfloat162 ha = as_bf16x2(a);
    const uint32_t take_a = __hneu2_mask(ha, ha) | __hge2_mask(ha, as_bf16x2(b));
    return (a & take_a) | (b & ~take_a);
  } else {
    const uint32_t lo = apply_one<OP>(a & 0xffffu, odd_w);
    const uint32_t hi = apply_one<OP>(a >> 16, odd_w);
    return lo | (hi << 16);
  }
}

template <int OP>
__device__ __forceinline__ uint4 apply(const uint4& a, const uint4& b, bool odd_w) {
  return make_uint4(apply_pair<OP>(a.x, b.x, odd_w), apply_pair<OP>(a.y, b.y, odd_w),
                    apply_pair<OP>(a.z, b.z, odd_w), apply_pair<OP>(a.w, b.w, odd_w));
}

// Block (blockIdx.x = n * Hout + h, blockIdx.y = chunk of the row): VPT
// vectors a thread, vector v = chunk * blockDim * VPT + k * blockDim + tid
// of the row's Wout << cv_bits.
template <int OP>
__global__ void __launch_bounds__(MAX_THREADS)
layout_probe_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int Hin, int Win,
                    int CinV, int Hout, int Wout, int cv_bits, ProbeGather a, ProbeGather b) {
  const int row = blockIdx.x;
  const int n = row / Hout;  // once per block
  const int h = row - n * Hout;
  const int row_vecs = Wout << cv_bits;
  const size_t in_row = static_cast<size_t>(Win) * CinV;
  const uint4* xa = x + (static_cast<size_t>(n) * Hin + map_index(a.h, h)) * in_row;
  const uint4* xb = x + (static_cast<size_t>(n) * Hin + map_index(b.h, h)) * in_row;
  const int cv_mask = (1 << cv_bits) - 1;
  const int first = blockIdx.y * blockDim.x * VPT + threadIdx.x;
  uint4 va[VPT], vb[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = first + k * blockDim.x;
    if (v < row_vecs) {
      const int w = v >> cv_bits, cv = v & cv_mask;
      va[k] = __ldg(xa + map_index(a.w, w) * CinV + cv);
      if (OP == MAX) vb[k] = __ldg(xb + map_index(b.w, w) * CinV + cv);
    }
  }
  uint4* o = out + static_cast<size_t>(row) * row_vecs;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = first + k * blockDim.x;
    if (v < row_vecs)
      __stcs(o + v, apply<OP>(va[k], OP == MAX ? vb[k] : va[k], (v >> cv_bits) & 1));
  }
}

template <int OP>
int launch(const void* x, void* out, const ProbeLaunch& p, cudaStream_t stream) {
  const int row_vecs = p.Wout << p.cv_bits;
  const int chunks = (row_vecs + p.threads * VPT - 1) / (p.threads * VPT);
  layout_probe_kernel<OP><<<dim3(p.N * p.Hout, chunks), p.threads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), p.Hin, p.Win, p.CinV, p.Hout,
      p.Wout, p.cv_bits, p.a, p.b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, Hin, Win, Cin) and out (N, Hout, Wout, Cout), bf16, contiguous,
// 16-byte aligned; Cin a multiple of 8 (CinV = Cin / 8 vectors a pixel),
// Cout / 8 = 1 << cv_bits <= CinV; every map in the form above with every
// mapped index inside the input; N * Hout < 2^31, Win * CinV < 2^31, at
// most 65535 chunks of threads * 4 vectors a row (the wrapper checks all
// of it). op: 0 COPY, 1 MAX (reads b), 2 NEGATE_ODD_W, 3 KEEP_POSITIVE.
// threads: a block's, a multiple of 32, at most 512. Returns
// cudaGetLastError() after the launch (0 = success); -1 for an unknown op
// or a bad thread count.
extern "C" int msfwsi_layout_probe(const void* x, void* out, const ProbeLaunch* p,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->threads < 32 || p->threads > MAX_THREADS || p->threads % 32) return -1;
  switch (p->op) {
    case COPY: return launch<COPY>(x, out, *p, s);
    case MAX: return launch<MAX>(x, out, *p, s);
    case NEGATE_ODD_W: return launch<NEGATE_ODD_W>(x, out, *p, s);
    case KEEP_POSITIVE: return launch<KEEP_POSITIVE>(x, out, *p, s);
    default: return -1;
  }
}
