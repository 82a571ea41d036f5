// FMA probe on Hopper (kernel 8 of the port).
//
// Replaces benchmarks/df64_push.py:fma_probe_kernel, the probe that asks the
// TPU compiler whether the source expression `a * b - p`, with `p = a * b`
// rounded to f32, is lowered to one fused multiply-add.  If it is, the result
// is the exact rounding error of the product, and the 17-operation Dekker
// two-product that a double-f32 kernel uses for that error collapses to one
// instruction.  Here the question goes to nvcc: its default, -fmad=true,
// contracts a multiply and a dependent add or subtract into an FMA.
//
// For f32 a, b of shape (8, 128) the kernel writes out (16, 128):
//   rows 0..7   `a * b - p`, written as that plain source expression so that
//               the compiler decides;
//   rows 8..15  the Dekker two-product error of the same product (splitter
//               4097), every operation an `__f*_rn` intrinsic, which the
//               compiler never contracts: the reference half stays Dekker
//               whatever the flags.
// `p` itself is `__fmul_rn(a, b)`: the rounded product, never part of an FMA.
//
// Bound: launch latency; the kernel reads 8 KB and writes 8 KB.
//
// Plain C interface: returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;
constexpr int COLS = 128;

// Veltkamp split of x into a 12-bit head and the rest, contraction-free.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  const float c = __fmul_rn(4097.0f, x);
  hi = __fsub_rn(c, __fsub_rn(c, x));
  lo = __fsub_rn(x, hi);
}

__global__ void fma_probe_kernel(const float* __restrict__ a_in,
                                 const float* __restrict__ b_in,
                                 float* __restrict__ out) {
  const int i = threadIdx.y * COLS + threadIdx.x;
  const float a = a_in[i], b = b_in[i];
  const float p = __fmul_rn(a, b);
  const float err_fma = a * b - p;  // exact iff compiled to one FMA
  float a_hi, a_lo, b_hi, b_lo;
  split(a, a_hi, a_lo);
  split(b, b_hi, b_lo);
  float e = __fsub_rn(__fmul_rn(a_hi, b_hi), p);
  e = __fadd_rn(e, __fmul_rn(a_hi, b_lo));
  e = __fadd_rn(e, __fmul_rn(a_lo, b_hi));
  e = __fadd_rn(e, __fmul_rn(a_lo, b_lo));
  out[i] = err_fma;
  out[ROWS * COLS + i] = e;
}

}  // namespace

extern "C" int gcge_fma_probe(const void* a, const void* b, void* out,
                              void* stream) {
  fma_probe_kernel<<<1, dim3(COLS, ROWS), 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}
