// Irregular (CSR) sparse matrix times multivector on Hopper (kernels 5 and 6
// of the port).
//
// Replaces gcge_tpu/ops/onehot_pallas.py:_onehot_spmm_t (f32: per packed
// (row-tile, column-window) pair two MXU products against one-hot select and
// scatter matrices built in the kernel, because the TPU has no gather) and
// :_onehot_spmm_t_df64 (the same product to ~2^-40 relative from bf16 planes,
// Dekker products and integer-slice scatters, because the TPU has no f64).
// Hopper has a gather and native f64, so neither the pairs nor the planes are
// carried over: one template on plain CSR serves both, csr_spmm<float> and
// csr_spmm<double>.
//
//   y[i, j] = sum_{p = rowptr[i]}^{rowptr[i+1]-1} values[p] * x[colidx[p], j]
//
// The sum runs in T, in CSR order (entries sorted by column within a row),
// one thread per output element, with no atomics: two launches on the same
// inputs give the same bits.  x and y are logical (n_cols, m) and (n, m)
// matrices given by 2-D strides, so the same kernel serves the row-major
// (n, m) layout of CsrOperator.matvec and the transposed (m, n) layout of
// matvec_t (the mixed-precision inner CG), including views, without a copy.
// The index map puts the contiguous dimension of y fastest: in the (n, m)
// layout the m threads of a row share its colidx/values reads and gather
// contiguous runs of x; in the (m, n) layout neighbouring threads walk
// neighbouring rows and gather x[j, colidx] from one n-long row of x.
//
// Bound: device memory bandwidth.  At the slice's shape (n = 250,047,
// nnz = 4,004,065, m = 10, f64) one call must move 12 B per nonzero (48 MB),
// 1 MB of rowptr and 20 MB each of x and y, for 2 * nnz * m = 80 MFLOP: under
// 1 FLOP/byte.  This first version reads each nonzero once per output column
// and relies on L1/L2 for the reuse (x, 20 MB, fits the 50 MB L2); staging
// rows in shared memory with a warp per row is later work.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void csr_spmm_kernel(const int* __restrict__ rowptr,
                                const int* __restrict__ colidx,
                                const T* __restrict__ values, int64_t n,
                                int64_t m, const T* __restrict__ x,
                                int64_t xs_i, int64_t xs_j, T* __restrict__ y,
                                int64_t ys_i, int64_t ys_j, int j_fast) {
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
  const int p1 = __ldg(rowptr + i + 1);
  const T* xj = x + j * xs_j;
  T acc = T(0);
  for (int p = __ldg(rowptr + i); p < p1; ++p)
    acc += __ldg(values + p) * xj[(int64_t)__ldg(colidx + p) * xs_i];
  y[i * ys_i + j * ys_j] = acc;
}

template <typename T>
int launch(const int* rowptr, const int* colidx, const T* values, int64_t n,
           int64_t m, const T* x, int64_t xs_i, int64_t xs_j, T* y,
           int64_t ys_i, int64_t ys_j, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n * m + threads - 1) / threads;
  const int j_fast = ys_j <= ys_i ? 1 : 0;
  csr_spmm_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rowptr, colidx, values, n, m, x, xs_i, xs_j, y, ys_i, ys_j, j_fast);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcge_csr_spmm_f64(const void* rowptr, const void* colidx,
                                 const void* values, int64_t n, int64_t m,
                                 const void* x, int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 void* stream) {
  return launch<double>((const int*)rowptr, (const int*)colidx,
                        (const double*)values, n, m, (const double*)x, xs_i,
                        xs_j, (double*)y, ys_i, ys_j, stream);
}

extern "C" int gcge_csr_spmm_f32(const void* rowptr, const void* colidx,
                                 const void* values, int64_t n, int64_t m,
                                 const void* x, int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 void* stream) {
  return launch<float>((const int*)rowptr, (const int*)colidx,
                       (const float*)values, n, m, (const float*)x, xs_i,
                       xs_j, (float*)y, ys_i, ys_j, stream);
}
