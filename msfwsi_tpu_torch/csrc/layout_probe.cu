// Layout probe kernels: gathers along H and W of an NHWC bf16 array, with
// an elementwise op on top.
//
// Replaces the Pallas TPU kernels of tools/diag/mosaic_probe.py,
// mosaic_probe2.py and mosaic_probe3.py (the pl.pallas_call in each
// try_one, 20 bodies in all): probes of strided slices, offset windows,
// reshapes, tiles, element repeats, rolls, an interleaving store, neighbour
// max and selects, the pieces of a max-pool backward. Each body is one
// launch of one of four kernels here:
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
// the input viewed in the output's shape. The wrapper checks that every
// mapped index lies inside the input. Channels are never remapped; the
// output may keep the first Cout of Cin channels.
//
// Bound on an H100: bytes. Every case reads each input element it needs
// once and writes each output element once, 16.8 MB each way for a
// (8,128,128,64) bf16 array, about 0.010 ms at 3.35 TB/s; the ops are one
// compare per element at most.
//
// Design: one thread per 8 consecutive channels, moved as one 16-byte load
// and store (C is a multiple of 8, so a pixel's channels are whole vectors
// and neighbouring threads touch neighbouring addresses). The ops work on
// the bf16 bit patterns: copies and selects move bits, negation flips the
// sign bit, compares go through fp32, so the results are exact. The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

struct ProbeAxisMap {
  int off, num, den, mod, alt;
};

struct ProbeGather {
  ProbeAxisMap h, w;
};

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // bf16 values per 16-byte vector

enum Op { COPY = 0, MAX = 1, NEGATE_ODD_W = 2, KEEP_POSITIVE = 3 };

__device__ __forceinline__ int map_index(const ProbeAxisMap& m, int i) {
  return (m.off + i * m.num / m.den) % m.mod + (i % 2) * m.alt;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// One bf16 value (the low 16 bits of a, b) through the op.
template <int OP>
__device__ __forceinline__ uint32_t apply_one(uint32_t a, uint32_t b, bool odd_w) {
  if (OP == COPY) return a;
  if (OP == NEGATE_ODD_W) return odd_w ? a ^ 0x8000u : a;
  const float fa = bf16_bits_to_float(a);
  if (OP == KEEP_POSITIVE) return (fa > 0.f || fa != fa) ? a : (a & 0x8000u);
  const float fb = bf16_bits_to_float(b);  // MAX
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fa >= fb ? a : b;
}

// Two bf16 values packed in a 32-bit word.
template <int OP>
__device__ __forceinline__ uint32_t apply_pair(uint32_t a, uint32_t b, bool odd_w) {
  const uint32_t lo = apply_one<OP>(a & 0xffffu, b & 0xffffu, odd_w);
  const uint32_t hi = apply_one<OP>(a >> 16, b >> 16, odd_w);
  return lo | (hi << 16);
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
layout_probe_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int N, int Hin,
                    int Win, int CinV, int Hout, int Wout, int CoutV, ProbeGather a,
                    ProbeGather b) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= N * Hout * Wout * CoutV) return;
  const int cv = idx % CoutV;
  int rest = idx / CoutV;
  const int w = rest % Wout;
  rest /= Wout;
  const int h = rest % Hout;
  const int n = rest / Hout;
  const size_t plane = (size_t)n * Hin;
  const uint4 va = x[((plane + map_index(a.h, h)) * Win + map_index(a.w, w)) * CinV + cv];
  uint4 vb = va;
  if (OP == MAX) vb = x[((plane + map_index(b.h, h)) * Win + map_index(b.w, w)) * CinV + cv];
  const bool odd_w = (w & 1) != 0;
  uint4 r;
  r.x = apply_pair<OP>(va.x, vb.x, odd_w);
  r.y = apply_pair<OP>(va.y, vb.y, odd_w);
  r.z = apply_pair<OP>(va.z, vb.z, odd_w);
  r.w = apply_pair<OP>(va.w, vb.w, odd_w);
  out[idx] = r;
}

template <int OP>
int launch(const void* x, void* out, int N, int Hin, int Win, int Cin, int Hout, int Wout,
           int Cout, const ProbeGather& a, const ProbeGather& b, cudaStream_t stream) {
  const int total = N * Hout * Wout * (Cout / VEC);
  const int blocks = (total + THREADS - 1) / THREADS;
  layout_probe_kernel<OP><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), N, Hin, Win, Cin / VEC, Hout,
      Wout, Cout / VEC, a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, Hin, Win, Cin) and out (N, Hout, Wout, Cout), bf16, contiguous,
// 16-byte aligned, Cin and Cout multiples of 8, Cout <= Cin, every mapped
// index inside the input, N*Hout*Wout*Cout/8 < 2^31 (the wrapper checks all
// of it). op: 0 COPY, 1 MAX (reads b), 2 NEGATE_ODD_W, 3 KEEP_POSITIVE.
// Returns cudaGetLastError() after the launch (0 = success); -1 for an
// unknown op.
extern "C" int msfwsi_layout_probe(const void* x, void* out, int op, int N, int Hin, int Win,
                                   int Cin, int Hout, int Wout, int Cout, const ProbeGather* a,
                                   const ProbeGather* b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case COPY: return launch<COPY>(x, out, N, Hin, Win, Cin, Hout, Wout, Cout, *a, *b, s);
    case MAX: return launch<MAX>(x, out, N, Hin, Win, Cin, Hout, Wout, Cout, *a, *b, s);
    case NEGATE_ODD_W:
      return launch<NEGATE_ODD_W>(x, out, N, Hin, Win, Cin, Hout, Wout, Cout, *a, *b, s);
    case KEEP_POSITIVE:
      return launch<KEEP_POSITIVE>(x, out, N, Hin, Win, Cin, Hout, Wout, Cout, *a, *b, s);
    default: return -1;
  }
}
