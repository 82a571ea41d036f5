// Jacobi sweeps on Hopper: the sweep loop of the polished eigensolvers.
//
// Replaces the jnp code of gcge_tpu/ops/eighs.py:jacobi_polish (lines
// 175-224: the while_loop of sweeps over _jacobi_round_systolic, line 135).
// No Pallas kernel stands there; on the TPU the loop is one XLA program.  In
// PyTorch a round is about ten launches, a sweep at m = 120 is 119 rounds,
// and the stop test before each sweep is a host read: this kernel runs the
// whole loop in one launch and exits on the device.
//
// For each matrix h1 (me x me, me even, row-major, in place) of a batch and
// v (written, from the identity): up to `sweeps` sweeps of me - 1 rounds.
// Before each sweep the largest |off-diagonal entry| is compared with
// 1e-13 * max|h1| (taken once, at entry); the loop stops when it is not
// larger.  A round pairs positions (i, me-1-i), computes the guarded 2x2
// Schur rotation (c, s) of each pair from the diagonal and the pair's
// entry, rotates the rows of every pair, then the columns, of h1, and the
// columns of v.  The plain version (ops/eighs.py:_jacobi_round_systolic)
// then permutes h1 and v by the circle method's sigma; here the positions
// stay put and round r maps position k to index
// pi_r(k) = k == 0 ? 0 : 1 + ((k - 1 - r) mod (me - 1)), which is what the
// permutations compose to.  After a sweep's me - 1 rounds pi is the
// identity again, so h1 and v between sweeps (where the stop test reads
// them) and at the end are the plain version's.  Every value goes through
// the same operations in the same order as the plain round, each rounded
// once: __dmul_rn/__dadd_rn/__dsub_rn/__ddiv_rn/__dsqrt_rn, which nvcc never
// contracts into fused multiply-adds, so the kernel gives the plain
// version's bits.
//
// Launch shape: one block a matrix.  Every rotation of round r + 1 reads a
// diagonal entry that round r wrote, so a round ends with a barrier; a
// block's __syncthreads costs tens of nanoseconds where a grid-wide barrier
// costs microseconds, and a round's work (9 me^2 operations, 130,000 at
// me = 120) is small for one SM.  So every matrix of a batch runs in one
// block, whatever its order: eigh_newton's cluster blocks (me <= 64: h1 and
// v both in shared memory, 64 KB at 64), the 'jacobi' backend's one matrix
// (me = 120 at the headline), the structural warm start's 2 bs (80, 160)
// and eigh_newton's closing-stage batches of up to 8 blocks of
// min(512, m) rows.  h1 sits in shared memory where it fits (me <= 168
// beside v in device memory; both at me <= 120); what does not fit is
// updated in place in device memory, where the 50 MB L2 cache holds it.
// The wrapper (ops/eighs.py:jacobi_plan) picks threads and placement.
//
// Bound: the operations, 9 me^3 a sweep, far below a millisecond at the
// card's f64 rate; what the kernel pays is the chain of me - 1 barriers a
// sweep, each behind a divide and two square roots.
//
// Plain C interface: returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double nan_max(double a, double b) {
  // torch.amax propagates NaN: so does this
  return (isnan(a) || a > b) ? a : b;
}

// block-wide max; every thread gets the result
__device__ double block_max(double x, double* red, double* out) {
  for (int o = 16; o > 0; o >>= 1)
    x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    double r = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = nan_max(r, red[w]);
    *out = r;
  }
  __syncthreads();
  return *out;
}

__device__ __forceinline__ double clamp_nan(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);   // NaN stays NaN (torch.clamp)
}

__device__ __forceinline__ double sign_of(double x) {
  return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x);   // torch.sign
}

// ops/eighs.py:_schur_cs, operation by operation
__device__ void schur_cs(double app, double aqq, double apq, double& c,
                         double& s) {
  const bool small = fabs(apq) <= 1e-300;
  const double apq_safe = small ? 1.0 : apq;
  const double tau = __ddiv_rn(__dsub_rn(aqq, app), __dmul_rn(2.0, apq_safe));
  const bool big = fabs(tau) > 1e7;
  const double tau_c = clamp_nan(tau, -1e7, 1e7);
  const double t_stable = __ddiv_rn(
      sign_of(tau_c),
      __dadd_rn(fabs(tau_c),
                __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(tau_c, tau_c)))));
  // 0.5 / x is PyTorch's reciprocal(x) * 0.5
  double t = big ? __dmul_rn(__drcp_rn(tau), 0.5) : t_stable;
  if (tau == 0.0) t = 1.0;
  if (small) t = 0.0;
  c = __drcp_rn(__dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
  s = __dmul_rn(t, c);
}

__device__ __forceinline__ int index_at(int k, int r, int me) {
  if (k == 0) return 0;
  const int n = me - 1;
  return 1 + (((k - 1 - r) % n) + n) % n;
}

__device__ __forceinline__ double rot_minus(double c, double x, double s,
                                            double y) {
  return __dsub_rn(__dmul_rn(c, x), __dmul_rn(s, y));   // c x - s y
}

__device__ __forceinline__ double rot_plus(double s, double x, double c,
                                           double y) {
  return __dadd_rn(__dmul_rn(s, x), __dmul_rn(c, y));   // s x + c y
}

__global__ void jacobi_sweeps_kernel(double* __restrict__ gh,
                                     double* __restrict__ gv,
                                     int* __restrict__ k_out, int me,
                                     int sweeps, int h_shared, int v_shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m2 = me / 2;
  const int nt = blockDim.x, tid = threadIdx.x;
  double* cs_c = reinterpret_cast<double*>(smem_raw);
  double* cs_s = cs_c + m2;
  double* red = cs_s + m2;
  double* bcast = red + (nt >> 5);
  int* pidx = reinterpret_cast<int*>(bcast + 2);
  int* qidx = pidx + m2;
  double* mats = reinterpret_cast<double*>(qidx + m2);
  const size_t mm = (size_t)me * me;
  double* gh_b = gh + (size_t)blockIdx.x * mm;
  double* gv_b = gv + (size_t)blockIdx.x * mm;
  double* H = h_shared ? mats : gh_b;
  double* V = v_shared ? mats + (h_shared ? mm : 0) : gv_b;

  if (h_shared)
    for (size_t i = tid; i < mm; i += nt) H[i] = gh_b[i];
  for (size_t i = tid; i < mm; i += nt)
    V[i] = (i / me == i % me) ? 1.0 : 0.0;
  __syncthreads();

  double loc = 0.0;
  for (size_t i = tid; i < mm; i += nt) loc = nan_max(loc, fabs(H[i]));
  double scale = block_max(loc, red, bcast);
  scale = scale < 1e-300 ? 1e-300 : scale;
  const double off_tol = __dmul_rn(1e-13, scale);

  int k = 0;
  for (; k < sweeps; ++k) {
    // h1 - diag(diag(h1)): the diagonal contributes h - h
    loc = 0.0;
    for (size_t i = tid; i < mm; i += nt) {
      const double x = H[i];
      loc = nan_max(loc, fabs(i / me == i % me ? __dsub_rn(x, x) : x));
    }
    const double off = block_max(loc, red, bcast);
    if (!(off > off_tol)) break;
    for (int r = 0; r < me - 1; ++r) {
      for (int i = tid; i < m2; i += nt) {
        const int p = index_at(i, r, me), q = index_at(me - 1 - i, r, me);
        pidx[i] = p;
        qidx[i] = q;
        schur_cs(H[p * me + p], H[q * me + q], H[p * me + q], cs_c[i],
                 cs_s[i]);
      }
      __syncthreads();
      // h1: each thread a 2 x 2 block of (row pair a) x (column pair b),
      // rows rotated, then columns
      for (int e = tid; e < m2 * m2; e += nt) {
        const int a = e / m2, b = e - a * m2;
        const int pa = pidx[a], qa = qidx[a], pb = pidx[b], qb = qidx[b];
        const double ca = cs_c[a], sa = cs_s[a], cb = cs_c[b], sb = cs_s[b];
        const double hpp = H[pa * me + pb], hpq = H[pa * me + qb];
        const double hqp = H[qa * me + pb], hqq = H[qa * me + qb];
        const double rpp = rot_minus(ca, hpp, sa, hqp);
        const double rqp = rot_plus(sa, hpp, ca, hqp);
        const double rpq = rot_minus(ca, hpq, sa, hqq);
        const double rqq = rot_plus(sa, hpq, ca, hqq);
        H[pa * me + pb] = rot_minus(cb, rpp, sb, rpq);
        H[pa * me + qb] = rot_plus(sb, rpp, cb, rpq);
        H[qa * me + pb] = rot_minus(cb, rqp, sb, rqq);
        H[qa * me + qb] = rot_plus(sb, rqp, cb, rqq);
      }
      // v: the columns of each pair, every row
      for (int e = tid; e < me * m2; e += nt) {
        const int y = e / m2, b = e - y * m2;
        const int pb = pidx[b], qb = qidx[b];
        const double cb = cs_c[b], sb = cs_s[b];
        const double vp = V[y * me + pb], vq = V[y * me + qb];
        V[y * me + pb] = rot_minus(cb, vp, sb, vq);
        V[y * me + qb] = rot_plus(sb, vp, cb, vq);
      }
      __syncthreads();
    }
  }

  if (h_shared)
    for (size_t i = tid; i < mm; i += nt) gh_b[i] = H[i];
  if (v_shared)
    for (size_t i = tid; i < mm; i += nt) gv_b[i] = V[i];
  if (tid == 0) k_out[blockIdx.x] = k;
}

}  // namespace

extern "C" int gcge_jacobi_sweeps(void* h, void* v, void* k_out, int64_t nb,
                                  int64_t me, int64_t sweeps,
                                  int64_t threads, int64_t h_shared,
                                  int64_t v_shared, int64_t smem,
                                  void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        jacobi_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  jacobi_sweeps_kernel<<<(unsigned)nb, (unsigned)threads, (size_t)smem,
                         (cudaStream_t)stream>>>(
      (double*)h, (double*)v, (int*)k_out, (int)me, (int)sweeps,
      (int)h_shared, (int)v_shared);
  return (int)cudaGetLastError();
}
