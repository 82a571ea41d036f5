// Jacobi sweeps on Hopper: the sweep loop of the polished eigensolvers, one
// thread-block cluster a matrix.
//
// Replaces the jnp code of gcge_tpu/ops/eighs.py:jacobi_polish (lines
// 175-224: the while_loop of sweeps over _jacobi_round_systolic, line 135).
// No Pallas kernel stands there; on the TPU the loop is one XLA program.  In
// PyTorch a round is about ten launches, a sweep at m = 120 is 119 rounds,
// and the stop test before each sweep is a host read: this kernel runs the
// whole loop in one launch and exits on the device.
//
// For each matrix h1 (me x me, me even, row-major) of a batch and v
// (written, from the identity): up to `sweeps` sweeps of me - 1 rounds.
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
// version's bits whatever the split over threads, blocks and SMs.
//
// Launch shape: a cluster of C blocks (1 <= C <= 16, one SM each) a matrix,
// launched by cudaLaunchKernelEx with a cluster dimension; grid (C, batch).
// Block j of a cluster owns the rows [j R, (j + 1) R) of its matrix, R =
// ceil(me / C) (the last blocks may own fewer, or none).
// - V's rotations act on the columns within a row, so V's rows never leave
//   their block.
// - H is double-buffered: round r reads buffer r & 1 and writes buffer
//   (r + 1) & 1.  Each block computes the new values of its own rows only:
//   row x of the pair (p, q) needs its partner's old row, which it reads
//   from the owner's buffer, through distributed shared memory where H
//   lives in shared memory and from device memory (L2) where it does not.
//   Nothing is written to another block, and the old buffer is only read
//   during a round, so one cluster barrier a round suffices (the next
//   round writes the buffer this one read only after every block passed
//   the barrier).
// - Every block forms all me/2 rotations of the round itself (the column
//   rotations of its rows need all of them), from H[p,p], H[q,q], H[p,q]
//   read from the owners' current buffers.
// - A round: rotations and the round's index maps (a table in shared
//   memory, advanced once a round without division), __syncthreads, the
//   block's rows of H, the arrival at the round's cluster barrier
//   (arrive.release), the block's rows of V, the wait (wait.acquire): V's
//   rotations hide behind the barrier (the next round reads V only after
//   its __syncthreads).
// - Threads: a thread owns one column pair b (more where me/2 exceeds the
//   block), the same in every row, and a group of the block's rows; no
//   division or modulo inside a round.  A warp reads 32 consecutive
//   columns of a row (the pairs' columns are consecutive indices up to one
//   wrap), so the row stride needs no padding.
// - The stop test is a cluster-wide max: each block reduces its own rows,
//   writes its max to a slot in its shared memory, and after a cluster
//   barrier every thread reads the C slots in rank order (NaN propagates).
// H's two buffers sit in shared memory where they fit beside the tables,
// else in device memory (the output and a scratch buffer of the wrapper);
// V likewise.  The wrapper (ops/eighs.py:jacobi_plan) picks C, the threads
// and the placement.
//
// Bound: the operations, 9 me^3 a sweep at the card's f64 rate.  What the
// kernel pays is per round: a cluster barrier, then a serial chain of
// remote loads and the rotation's divide and square roots, then the block's
// 9 R me operations; with R rows a block the work a round shrinks by C, the
// chain does not (about 2 us a round on an H100 where H and V sit in
// shared memory).  Where they do not, the block's rows stream through L2
// every round (H's own, partner and new rows, V's read and written: about
// 5 R me doubles), which sets the pace at 480 and more.  Forming the next
// round's rotations between the arrival and the wait (a third buffer of H
// keeps their inputs) measured slower at every size: it lengthens the
// chain more than the barrier hides.
//
// Plain C interface: returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ double rot_minus(double c, double x, double s,
                                            double y) {
  return __dsub_rn(__dmul_rn(c, x), __dmul_rn(s, y));   // c x - s y
}

__device__ __forceinline__ double rot_plus(double s, double x, double c,
                                           double y) {
  return __dadd_rn(__dmul_rn(s, x), __dmul_rn(c, y));   // s x + c y
}

// H's loads and stores: shared memory (local or another block's, by
// generic address) where HS, else device memory past L1 (other SMs of the
// cluster write it between rounds)
template <bool HS>
__device__ __forceinline__ double ldh(const double* p) {
  if constexpr (HS) return *p;
  else return __ldcg(p);
}

template <bool HS>
__device__ __forceinline__ void sth(double* p, double x) {
  if constexpr (HS) *p = x;
  else __stcg(p, x);
}

// the two halves of a cluster barrier: the arrival releases this thread's
// writes, the wait acquires every thread's of the cluster (the PTX
// defaults of barrier.cluster.arrive and .wait)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// the index at position k in the next round, from the index x at k now
__device__ __forceinline__ int next_index(int x, int me) {
  return x == 0 ? 0 : (x == 1 ? me - 1 : x - 1);
}

// the position of an index in the next round, from its position k now
__device__ __forceinline__ int next_position(int k, int me) {
  return k == 0 ? 0 : (k == me - 1 ? 1 : k + 1);
}

// rows of a thread's group handled together: their loads are issued
// before any of their stores
constexpr int UNROLL = 4;

// Shared memory, in this order (ops/eighs.py:jacobi_plan sizes it):
//   H's two buffers (R x me doubles each, where HS), V (R x me, where VS),
//   the rotations cs_c, cs_s (me/2 each), the reduction's 32 doubles,
//   4 slots, the row pointers of both buffers (2 me), the partner row of
//   each own row (R pointers), the index maps (2 parities x 2 x me/2 ints),
//   each own row's position, pair and side (3 R ints).
template <bool HS, bool VS>
__global__ void jacobi_cluster_kernel(double* __restrict__ gh,
                                      double* __restrict__ gs,
                                      double* __restrict__ gv,
                                      int* __restrict__ k_out, int me,
                                      int sweeps, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int R = rows_per_block;
  const int m2 = me / 2;
  const int nt = blockDim.x, tid = threadIdx.x;
  const size_t mm = (size_t)me * me;
  const size_t rmat = (size_t)R * me;

  double* sp = reinterpret_cast<double*>(smem_raw);
  double* hloc0 = sp;
  double* hloc1 = sp + (HS ? rmat : 0);
  sp += HS ? 2 * rmat : 0;
  double* vloc = sp;
  sp += VS ? rmat : 0;
  double* cs_c = sp;
  double* cs_s = cs_c + m2;
  double* red = cs_s + m2;
  double* slots = red + 32;   // 0: max|h1|, 1: off, 2: block_max's result
  const double** rowp = reinterpret_cast<const double**>(slots + 4);
  const double** prow = rowp + 2 * me;
  int* idx = reinterpret_cast<int*>(prow + R);   // [parity][p|q][m2]
  int* pos = idx + 4 * m2;
  int* role_a = pos + R;
  int* role_side = role_a + R;

  const int mat = blockIdx.y;
  double* gh_m = gh + (size_t)mat * mm;
  double* gs_m = HS ? nullptr : gs + (size_t)mat * mm;
  double* gv_m = gv + (size_t)mat * mm;
  const int row0 = rank * R;
  const int nown = max(0, min(R, me - row0));

  // own rows of H in each buffer, and of V
  double* own0 = HS ? hloc0 : gh_m + (size_t)row0 * me;
  double* own1 = HS ? hloc1 : gs_m + (size_t)row0 * me;
  double* vrow = VS ? vloc : gv_m + (size_t)row0 * me;

  // lanes: a thread owns the column pairs b0, b0 + bstep, ... and the own
  // rows g, g + G, ...
  int G, g, b0, bstep;
  const bool one_pair = nt >= m2;   // at most one column pair a thread
  if (one_pair) {
    G = nt / m2;
    g = tid / m2;
    b0 = g < G ? tid - g * m2 : m2;
    bstep = m2;
  } else {
    G = 1;
    g = 0;
    b0 = tid;
    bstep = nt;
  }

  // set-up: the rows, the row pointers, the round-0 maps
  if (HS)
    for (size_t i = tid; i < (size_t)nown * me; i += nt)
      hloc0[i] = gh_m[(size_t)row0 * me + i];
  for (int l = 0; l < nown; ++l)
    for (int y = tid; y < me; y += nt)
      vrow[(size_t)l * me + y] = (row0 + l == y) ? 1.0 : 0.0;
  for (int x = tid; x < me; x += nt) {
    const int owner = x / R, lx = x - owner * R;
    if (HS) {
      // the block's own rows by their local address (shared memory's own
      // path), the others' through the cluster's window
      double* b0 = owner == rank ? hloc0
                                 : cluster.map_shared_rank(hloc0, owner);
      double* b1 = owner == rank ? hloc1
                                 : cluster.map_shared_rank(hloc1, owner);
      rowp[x] = b0 + (size_t)lx * me;
      rowp[me + x] = b1 + (size_t)lx * me;
    } else {
      rowp[x] = gh_m + (size_t)x * me;
      rowp[me + x] = gs_m + (size_t)x * me;
    }
  }
  for (int i = tid; i < m2; i += nt) {   // pi_0 is the identity
    idx[i] = i;
    idx[m2 + i] = me - 1 - i;
  }
  for (int l = tid; l < nown; l += nt) pos[l] = row0 + l;
  cluster.sync();

  // max|h1| over the cluster: each block's rows, then the blocks in order
  auto cluster_max = [&](double loc, int slot) {
    const double b = block_max(loc, red, slots + 2);
    if (tid == 0) slots[slot] = b;
    cluster.sync();
    double r = *cluster.map_shared_rank(slots + slot, 0);
    for (int j = 1; j < C; ++j)
      r = nan_max(r, *cluster.map_shared_rank(slots + slot, j));
    return r;
  };

  double loc = 0.0;
  for (int l = 0; l < nown; ++l)
    for (int y = tid; y < me; y += nt)
      loc = nan_max(loc, fabs(own0[(size_t)l * me + y]));
  double scale = cluster_max(loc, 0);
  scale = scale < 1e-300 ? 1e-300 : scale;
  const double off_tol = __dmul_rn(1e-13, scale);

  int k = 0, cur = 0;
  for (; k < sweeps; ++k) {
    // h1 - diag(diag(h1)): the diagonal contributes h - h
    const double* hc = cur ? own1 : own0;
    loc = 0.0;
    for (int l = 0; l < nown; ++l)
      for (int y = tid; y < me; y += nt) {
        const double x = ldh<HS>(hc + (size_t)l * me + y);
        loc = nan_max(loc, fabs(row0 + l == y ? __dsub_rn(x, x) : x));
      }
    const double off = cluster_max(loc, 1);
    if (!(off > off_tol)) break;
    for (int r = 0; r < me - 1; ++r) {
      const int nxt = cur ^ 1;
      const int* pc = idx + cur * 2 * m2;
      const int* qc = pc + m2;
      int* pn = idx + nxt * 2 * m2;
      int* qn = pn + m2;
      const double** rp = rowp + cur * me;
      // the round's rotations, from the owners' current rows
      for (int i = tid; i < m2; i += nt) {
        const int p = pc[i], q = qc[i];
        const double* hp = rp[p];
        schur_cs(ldh<HS>(hp + p), ldh<HS>(rp[q] + q), ldh<HS>(hp + q),
                 cs_c[i], cs_s[i]);
        pn[i] = next_index(p, me);
        qn[i] = next_index(q, me);
      }
      // each own row's pair, side and partner row
      for (int l = tid; l < nown; l += nt) {
        const int kp = pos[l];
        const bool pside = kp < m2;
        const int a = pside ? kp : me - 1 - kp;
        role_a[l] = a;
        role_side[l] = pside ? 0 : 1;
        prow[l] = rp[pside ? qc[a] : pc[a]];
        pos[l] = next_position(kp, me);
      }
      __syncthreads();
      const double* hx = cur ? own1 : own0;
      double* hn = cur ? own0 : own1;
      // h1: the row rotation of each own row with its partner, then the
      // column rotation of the pair (pb, qb) within the row
      auto h_rows = [&](int pb, int qb, double cb, double sb) {
        for (int l0 = g; l0 < nown; l0 += UNROLL * G) {
          double x0[UNROLL], x1[UNROLL], y0[UNROLL], y1[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int l = l0 + u * G;
            if (l < nown) {
              const double* xr = hx + (size_t)l * me;
              const double* yr = prow[l];
              x0[u] = ldh<HS>(xr + pb);
              x1[u] = ldh<HS>(xr + qb);
              y0[u] = ldh<HS>(yr + pb);
              y1[u] = ldh<HS>(yr + qb);
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int l = l0 + u * G;
            if (l < nown) {
              const int a = role_a[l];
              const double ca = cs_c[a], sa = cs_s[a];
              double r0, r1;
              if (role_side[l] == 0) {   // row p: c h[p] - s h[q]
                r0 = rot_minus(ca, x0[u], sa, y0[u]);
                r1 = rot_minus(ca, x1[u], sa, y1[u]);
              } else {                   // row q: s h[p] + c h[q]
                r0 = rot_plus(sa, y0[u], ca, x0[u]);
                r1 = rot_plus(sa, y1[u], ca, x1[u]);
              }
              double* nr = hn + (size_t)l * me;
              sth<HS>(nr + pb, rot_minus(cb, r0, sb, r1));
              sth<HS>(nr + qb, rot_plus(sb, r0, cb, r1));
            }
          }
        }
      };
      // v: the columns (pb, qb) of each own row
      auto v_rows = [&](int pb, int qb, double cb, double sb) {
        for (int l0 = g; l0 < nown; l0 += UNROLL * G) {
          double vp[UNROLL], vq[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int l = l0 + u * G;
            if (l < nown) {
              vp[u] = vrow[(size_t)l * me + pb];
              vq[u] = vrow[(size_t)l * me + qb];
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int l = l0 + u * G;
            if (l < nown) {
              vrow[(size_t)l * me + pb] = rot_minus(cb, vp[u], sb, vq[u]);
              vrow[(size_t)l * me + qb] = rot_plus(sb, vp[u], cb, vq[u]);
            }
          }
        }
      };
      if (one_pair) {
        // V's rows are the block's own and read no shared table past the
        // registers: they rotate between the arrival at the round's
        // cluster barrier and the wait (the next round reads them after
        // its __syncthreads)
        const bool act = b0 < m2;
        int pb = 0, qb = 0;
        double cb = 0.0, sb = 0.0;
        if (act) {
          pb = pc[b0];
          qb = qc[b0];
          cb = cs_c[b0];
          sb = cs_s[b0];
          h_rows(pb, qb, cb, sb);
        }
        cluster_arrive();
        if (act) v_rows(pb, qb, cb, sb);
        cluster_wait();
      } else {
        for (int b = b0; b < m2; b += bstep) {
          const int pb = pc[b], qb = qc[b];
          const double cb = cs_c[b], sb = cs_s[b];
          h_rows(pb, qb, cb, sb);
          v_rows(pb, qb, cb, sb);
        }
        cluster.sync();
      }
      cur = nxt;
    }
  }

  // the own rows out: H from its current buffer, V where it is shared
  // (the last round's V rows were written after the cluster barrier)
  __syncthreads();
  const double* hc = cur ? own1 : own0;
  if (HS || cur)
    for (size_t i = tid; i < (size_t)nown * me; i += nt)
      gh_m[(size_t)row0 * me + i] = ldh<HS>(hc + i);
  if (VS)
    for (size_t i = tid; i < (size_t)nown * me; i += nt)
      gv_m[(size_t)row0 * me + i] = vloc[i];
  if (rank == 0 && tid == 0) k_out[mat] = k;
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <bool HS, bool VS>
cudaError_t launch(const cudaLaunchConfig_t* cfg, double* h, double* s,
                   double* v, int* k, int me, int sweeps, int rows) {
  return cudaLaunchKernelEx(cfg, jacobi_cluster_kernel<HS, VS>, h, s, v, k,
                            me, sweeps, rows);
}

template <bool HS, bool VS>
cudaError_t prepare(int cluster, int smem) {
  const void* fn = (const void*)jacobi_cluster_kernel<HS, VS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <bool HS, bool VS>
cudaError_t occupancy(const cudaLaunchConfig_t* cfg, int* n) {
  return cudaOccupancyMaxActiveClusters(n, jacobi_cluster_kernel<HS, VS>,
                                        cfg);
}

cudaError_t prepare_any(int hs, int vs, int cluster, int smem) {
  if (hs) return vs ? prepare<true, true>(cluster, smem)
                    : prepare<true, false>(cluster, smem);
  return vs ? prepare<false, true>(cluster, smem)
            : prepare<false, false>(cluster, smem);
}

void config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cluster,
            int nb, int threads, int smem, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)cluster, (unsigned)nb, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// h (nb, me, me) in place; scratch: H's second buffer where it is not in
// shared memory (else unused); v (nb, me, me) out; k_out (nb,) int32
extern "C" int gcge_jacobi_sweeps(void* h, void* scratch, void* v,
                                  void* k_out, int64_t nb, int64_t me,
                                  int64_t sweeps, int64_t cluster,
                                  int64_t rows, int64_t threads,
                                  int64_t h_shared, int64_t v_shared,
                                  int64_t smem, void* stream) {
  cudaError_t err = prepare_any((int)h_shared, (int)v_shared, (int)cluster,
                                (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, (int)cluster, (int)nb, (int)threads, (int)smem,
         (cudaStream_t)stream);
  double* hd = (double*)h;
  double* sd = (double*)scratch;
  double* vd = (double*)v;
  int* kd = (int*)k_out;
  const int m = (int)me, sw = (int)sweeps, r = (int)rows;
  if (h_shared)
    err = v_shared ? launch<true, true>(&cfg, hd, sd, vd, kd, m, sw, r)
                   : launch<true, false>(&cfg, hd, sd, vd, kd, m, sw, r);
  else
    err = v_shared ? launch<false, true>(&cfg, hd, sd, vd, kd, m, sw, r)
                   : launch<false, false>(&cfg, hd, sd, vd, kd, m, sw, r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the error
extern "C" int gcge_jacobi_max_clusters(int64_t cluster, int64_t threads,
                                        int64_t h_shared, int64_t v_shared,
                                        int64_t smem) {
  cudaError_t err = prepare_any((int)h_shared, (int)v_shared, (int)cluster,
                                (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, (int)cluster, 1, (int)threads, (int)smem, 0);
  int n = 0;
  if (h_shared)
    err = v_shared ? occupancy<true, true>(&cfg, &n)
                   : occupancy<true, false>(&cfg, &n);
  else
    err = v_shared ? occupancy<false, true>(&cfg, &n)
                   : occupancy<false, false>(&cfg, &n);
  if (err != cudaSuccess) return -(int)err;
  return n;
}
