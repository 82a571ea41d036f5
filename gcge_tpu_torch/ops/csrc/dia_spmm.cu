// DIA sparse matrix times multivector on Hopper (kernels 1 and 2 of the port).
//
// Replaces gcge_tpu/ops/spmm_pallas.py:_dia_spmm_t_df64 (f64 quality from
// f32 hi/lo planes, because the TPU has no f64) and :_dia_spmm_t (the f32
// kernel of the mixed-precision inner CG).  Hopper has native f64, so one
// template serves both: dia_spmm<double> and dia_spmm<float>.
//
//   y[i, j] = sum_d values[d, i] * x[i + off_d, j]     (0 <= i + off_d < n)
//
// The sum runs in T, in the order of the offsets, as both TPU paths do.
// x and y are logical (n, m) matrices given by 2-D strides, so the same
// kernel serves the row-major (n, m) layout of DiaOperator.matvec and the
// transposed (m, n) layout of matvec_t, including transposed views, without
// a copy.  One thread computes one output element; the index map puts the
// contiguous dimension of y fastest, so stores coalesce and the value row
// values[d, i] is shared by neighbouring threads.
//
// Bound: device memory bandwidth.  At the headline shape (27 diagonals,
// n = 157,464, m = 10, f64) one call moves 34 MB of values plus 12.6 MB of
// x and 12.6 MB of y for 2 * 27 * n * m = 85 MFLOP, about 1.4 FLOP/byte,
// far below the card's f64 ridge.  The design reads each value once per
// output and relies on L1/L2 for the 27 reuses of each x element; the
// neighbouring diagonals of a stencil hit the same cache lines.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void dia_spmm_kernel(const T* __restrict__ values,
                                const int* __restrict__ offsets, int ndiag,
                                int64_t n, int64_t m,
                                const T* __restrict__ x, int64_t xs_i,
                                int64_t xs_j, T* __restrict__ y, int64_t ys_i,
                                int64_t ys_j, int j_fast) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * m) return;
  int64_t i, j;
  if (j_fast) {
    i = t / m;
    j = t - i * m;
  } else {
    j = t / n;
    i = t - j * n;
  }
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t c = i + (int64_t)__ldg(offsets + d);
    if (c >= 0 && c < n) acc += values[(int64_t)d * n + i] * x[c * xs_i + j * xs_j];
  }
  y[i * ys_i + j * ys_j] = acc;
}

template <typename T>
int launch(const T* values, const int* offsets, int64_t ndiag, int64_t n,
           int64_t m, const T* x, int64_t xs_i, int64_t xs_j, T* y,
           int64_t ys_i, int64_t ys_j, void* stream) {
  const int threads = 256;
  const int64_t total = n * m;
  const int64_t blocks = (total + threads - 1) / threads;
  const int j_fast = ys_j <= ys_i ? 1 : 0;
  dia_spmm_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      values, offsets, (int)ndiag, n, m, x, xs_i, xs_j, y, ys_i, ys_j, j_fast);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcge_dia_spmm_f64(const void* values, const void* offsets,
                                 int64_t ndiag, int64_t n, int64_t m,
                                 const void* x, int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 void* stream) {
  return launch<double>((const double*)values, (const int*)offsets, ndiag, n,
                        m, (const double*)x, xs_i, xs_j, (double*)y, ys_i,
                        ys_j, stream);
}

extern "C" int gcge_dia_spmm_f32(const void* values, const void* offsets,
                                 int64_t ndiag, int64_t n, int64_t m,
                                 const void* x, int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 void* stream) {
  return launch<float>((const float*)values, (const int*)offsets, ndiag, n, m,
                       (const float*)x, xs_i, xs_j, (float*)y, ys_i, ys_j,
                       stream);
}
