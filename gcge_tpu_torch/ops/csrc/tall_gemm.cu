// Tall-skinny f64 GEMMs on Hopper (kernels 3 and 4 of the port).
//
// Kernel 3, tall Gram C = A^T B, A (n, p), B (n, q), n >> p, q.
//   Replaces gcge_tpu/ops/osgemm_pallas.py:_os_gram_kernel_call, which
//   reaches ~2^-46 accuracy on the TPU from 7 bf16 slices and 28 slice-pair
//   matrix-unit products with a compensated f32 result.  Hopper has native
//   f64, so the port multiplies in f64 and slices nothing.
//   Design: split-K.  Pass 1 gives each block one (32 x 32) output tile and
//   one chunk of rows; it stages 32-row tiles of A and B in shared memory
//   and sums in f64 registers (4 outputs a thread), then writes its partial
//   tile to scratch (chunks, p, q).  Pass 2 sums the partials of each
//   output in chunk order.  No atomics: the result is the same from run to
//   run, with the accuracy of a chunked f64 sum (gcge_tpu_torch.ops.multivec.gram).
//   Bound: at the headline shapes (n = 157,464, p <= 120, q from 10 to 120)
//   one call reads 8 n (p + q) bytes, at most 302 MB, for 2 n p q FLOP; the
//   (120 x 10) Gram is bandwidth-bound, the (120 x 120) one sits near the
//   f64 ridge.  The split over row chunks keeps enough blocks in flight to
//   fill the 132 SMs even when the output is a single tile.
//
// Kernel 4, tall expand Y = A C, A (n, k), C (k, q) small.
//   Replaces gcge_tpu/ops/osgemm_pallas.py:_os_expand_kernel_call (the same
//   sliced bf16 arithmetic, (hi, lo) f32 result).  Here plain f64.
//   Design: each block owns 64 rows and a 32-column tile of Y; it walks k in
//   steps of 32, staging the (64 x 32) tile of A and the (32 x 32) tile of C
//   in shared memory; each thread keeps 8 outputs in f64 registers.  There is
//   no limit on k (the TPU's k <= 1024 came from bf16 exactness).  Blocks
//   that share rows are adjacent in the launch order, so the q-tiles of one
//   row block read A from L2 rather than device memory.
//   Bound: one call reads 8 n k bytes of A and writes 8 n q bytes of Y
//   (k = 120, q = 100 at the headline: 151 MB + 126 MB) for 2 n k q FLOP,
//   near the f64 ridge; the first kernel is simple, not tuned.
//
// Operands A, B and C are given by 2-D strides (column slices of the solver's
// basis are strided views); outputs are contiguous row-major.  Plain C
// interface (built with nvcc, loaded with ctypes): each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---- kernel 3: tall Gram ----------------------------------------------------
constexpr int kGT = 32;  // output tile edge
constexpr int kGK = 32;  // rows staged per step

__global__ void tall_gram_partial(const double* __restrict__ a, int64_t as0,
                                  int64_t as1, const double* __restrict__ b,
                                  int64_t bs0, int64_t bs1, int64_t n,
                                  int64_t p, int64_t q, int64_t rows_per_chunk,
                                  double* __restrict__ part) {
  __shared__ double sa[kGK][kGT + 1];
  __shared__ double sb[kGK][kGT + 1];
  const int tx = threadIdx.x % kGT;  // output column within the tile
  const int ty = threadIdx.x / kGT;  // 0..7: output rows ty, ty+8, ...
  const int64_t p0 = (int64_t)blockIdx.x * kGT;
  const int64_t q0 = (int64_t)blockIdx.y * kGT;
  const int64_t chunk = blockIdx.z;
  const int64_t r0 = chunk * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < n ? r0 + rows_per_chunk : n;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t k0 = r0; k0 < r1; k0 += kGK) {
    for (int e = threadIdx.x; e < kGK * kGT; e += kThreads) {
      const int kk = e / kGT, cc = e % kGT;
      const int64_t r = k0 + kk;
      const bool row_ok = r < r1;
      sa[kk][cc] = (row_ok && p0 + cc < p) ? a[r * as0 + (p0 + cc) * as1] : 0.0;
      sb[kk][cc] = (row_ok && q0 + cc < q) ? b[r * bs0 + (q0 + cc) * bs1] : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kGK; ++kk) {
      const double bv = sb[kk][tx];
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[s] += sa[kk][ty + 8 * s] * bv;
    }
    __syncthreads();
  }
  const int64_t qi = q0 + tx;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int64_t pi = p0 + ty + 8 * s;
    if (pi < p && qi < q) part[(chunk * p + pi) * q + qi] = acc[s];
  }
}

__global__ void tall_gram_reduce(const double* __restrict__ part,
                                 int64_t nchunks, int64_t pq,
                                 double* __restrict__ c) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pq) return;
  double s = 0.0;
  for (int64_t k = 0; k < nchunks; ++k) s += part[k * pq + t];
  c[t] = s;
}

// ---- kernel 4: tall expand -------------------------------------------------
constexpr int kER = 64;  // rows of Y per block
constexpr int kEQ = 32;  // columns of Y per block
constexpr int kEK = 32;  // contraction step

__global__ void tall_expand_kernel(const double* __restrict__ a, int64_t as0,
                                   int64_t as1, const double* __restrict__ c,
                                   int64_t cs0, int64_t cs1, int64_t n,
                                   int64_t k, int64_t q, int64_t q_tiles,
                                   double* __restrict__ y) {
  __shared__ double sa[kER][kEK + 1];
  __shared__ double sc[kEK][kEQ];
  const int tx = threadIdx.x % kEQ;  // output column within the tile
  const int ty = threadIdx.x / kEQ;  // 0..7: output rows ty, ty+8, ...
  const int64_t q0 = (int64_t)(blockIdx.x % q_tiles) * kEQ;
  const int64_t i0 = (int64_t)(blockIdx.x / q_tiles) * kER;
  double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t k0 = 0; k0 < k; k0 += kEK) {
    for (int e = threadIdx.x; e < kER * kEK; e += kThreads) {
      const int rr = e / kEK, kk = e % kEK;
      const int64_t row = i0 + rr, kc = k0 + kk;
      sa[rr][kk] = (row < n && kc < k) ? a[row * as0 + kc * as1] : 0.0;
    }
    for (int e = threadIdx.x; e < kEK * kEQ; e += kThreads) {
      const int kk = e / kEQ, cc = e % kEQ;
      const int64_t kc = k0 + kk, col = q0 + cc;
      sc[kk][cc] = (kc < k && col < q) ? c[kc * cs0 + col * cs1] : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kEK; ++kk) {
      const double cv = sc[kk][tx];
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[s] += sa[ty + 8 * s][kk] * cv;
    }
    __syncthreads();
  }
  const int64_t col = q0 + tx;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int64_t row = i0 + ty + 8 * s;
    if (row < n && col < q) y[row * q + col] = acc[s];
  }
}

}  // namespace

extern "C" int gcge_tall_gram_f64(const void* a, int64_t as0, int64_t as1,
                                  const void* b, int64_t bs0, int64_t bs1,
                                  int64_t n, int64_t p, int64_t q,
                                  int64_t nchunks, int64_t rows_per_chunk,
                                  void* part, void* c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((p + kGT - 1) / kGT), (unsigned)((q + kGT - 1) / kGT),
            (unsigned)nchunks);
  tall_gram_partial<<<grid, kThreads, 0, s>>>(
      (const double*)a, as0, as1, (const double*)b, bs0, bs1, n, p, q,
      rows_per_chunk, (double*)part);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t pq = p * q;
  tall_gram_reduce<<<(unsigned)((pq + kThreads - 1) / kThreads), kThreads, 0,
                     s>>>((const double*)part, nchunks, pq, (double*)c);
  return (int)cudaGetLastError();
}

extern "C" int gcge_tall_expand_f64(const void* a, int64_t as0, int64_t as1,
                                    const void* c, int64_t cs0, int64_t cs1,
                                    int64_t n, int64_t k, int64_t q, void* y,
                                    void* stream) {
  const int64_t q_tiles = (q + kEQ - 1) / kEQ;
  const int64_t row_blocks = (n + kER - 1) / kER;
  tall_expand_kernel<<<(unsigned)(q_tiles * row_blocks), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const double*)a, as0, as1, (const double*)c, cs0, cs1, n, k, q, q_tiles,
      (double*)y);
  return (int)cudaGetLastError();
}
