// Tall-skinny f64 GEMMs on Hopper (kernels 3 and 4 of the port), on the f64
// tensor cores (mma.sync m16n8k8 .f64), fed by a ring of cp.async copies.
//
// Kernel 3, tall Gram C = A^T B, A (n, p), B (n, q), n >> p, q.
//   Replaces gcge_tpu/ops/osgemm_pallas.py:_os_gram_kernel_call, which
//   reaches ~2^-46 accuracy on the TPU from 7 bf16 slices and 28 slice-pair
//   matrix-unit products.  Hopper multiplies in f64, so nothing is sliced.
//   Bound on the H100 (3.35 TB/s, 67 TFLOP/s f64 on the tensor cores): one
//   call reads 8 n (p + q) bytes for 2 n p q operations.  At n = 157,464 the
//   (120 x 10) and (110 x 10) Grams are bound by their bytes (0.049 ms
//   against 0.006 ms of operations), and so is (100 x 100) (0.075 against
//   0.047 ms), but only on the tensor cores: on the CUDA cores' 34 TFLOP/s
//   its operations alone need 0.093 ms.
//   Design: as the TPU kernel streams row tiles of A and B once with its
//   output block resident, each block here owns one chunk of rows and the
//   whole (<= 128 x 128) output tile; A and B are read from device memory
//   once.  Stages of bk rows of A and B stream through a ring of kStages
//   stages in shared memory.  Consumer warp w holds one 16-row m-tile of C
//   and all its 8-column n-tiles in DMMA accumulators; where C has fewer
//   than eight m-tiles, the warps of one m-tile split the stage's k-steps
//   and add their sums in shared memory, in warp order.  Each block writes
//   its chunk's partial C; a second launch adds the partials in chunk order.
//   No atomics, and no counter that outlives a call: the result is the same
//   from launch to launch, on any stream, inside a CUDA graph or not, for the
//   price of one launch boundary.  Outputs above 128 x 128 are tiled over
//   the grid's y.
//
// Kernel 4, tall expand Y = A C, A (n, k), C (k, q) small.
//   Replaces gcge_tpu/ops/osgemm_pallas.py:_os_expand_kernel_call (the same
//   sliced bf16 arithmetic, (hi, lo) f32 result).  Here plain f64.
//   Bound: 8 n (k + q) bytes for 2 n k q operations; at the headline's
//   (n x 120)(120 x 100) 0.083 ms of bytes against 0.056 ms of operations on
//   the tensor cores, 0.111 ms on the CUDA cores: only the tensor cores leave
//   it bound by its bytes.
//   Design: as the TPU kernel keeps C resident across its grid, each block
//   copies C (up to 128 columns, up to ~128 rows) into shared memory once,
//   in the order of the mma's B fragments, then walks row tiles of A as a
//   persistent block (one per SM).  Row tiles of 64 rows stream through the
//   ring in k-slices of 40 columns; consumer warp (wm, wn) multiplies rows
//   16 wm .. 16 wm + 15 by the n-tiles wn, wn + 2, ... of C, and stores its
//   part of Y with 16-byte stores once a tile's last slice is in.  A is read
//   from device memory once.  The mma's k index t (and t + 4) of a k-step is
//   mapped to column 2t (and 2t + 1), so that a thread's two A values of a
//   row are adjacent: one 16-byte shared load.  Where C does not fit (k q 8
//   bytes above ~145 KB), the entry point loops over q-tiles and k-chunks of
//   C, one launch each, later k-chunks adding into Y in order.
//
// The pipeline of both: kProducers warps (one warpgroup) only copy.  They
// fill a stage with cp.async (zero-filling rows past the end and columns past
// the operand) and signal its full barrier by cp.async.mbarrier.arrive; the
// kConsumers warps wait on it, multiply, and release the stage on its empty
// barrier.  A warp that issues copies stalls once the memory pipe is full, so
// the warps that multiply never issue any: copies and multiplies overlap.
// An f64 mma waits a long time for its predecessor on the same accumulator,
// so a consumer keeps several independent accumulator sets (SETS) where it
// has few output tiles, and adds them in a fixed order at the end.
//
// Operands are given by 2-D strides (column slices of the solver's basis are
// strided views); outputs are contiguous row-major.  VEC = 2 copies 16 bytes
// (operands whose rows start on 16 bytes and whose columns are contiguous);
// VEC = 1 copies each element by itself (8 bytes, any strides).  Plain C
// interface (built with nvcc, loaded with ctypes): each entry point returns
// the first CUDA error of its launches, or 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 8;  // warps that multiply
constexpr int kProducers = 4;  // warps that copy: one warpgroup
constexpr int kThreads = 32 * (kConsumers + kProducers);
constexpr int kCopiers = 32 * kProducers;
constexpr int kStages = 4;  // depth of the ring

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of VEC doubles from device to shared memory; the bytes
// past `src_bytes` are written as zeros (src_bytes = 0: no read at all).
template <int VEC>
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int src_bytes) {
  if (VEC == 2) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrives on `bar` once every cp.async of this thread so far has landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the consumer warps only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

// d += A B for one 16 x 8 x 8 tile on the f64 tensor cores.  With g = lane/4
// and t = lane%4: a = (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]),
// b = (B[t][g], B[t+4][g]), d = (D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]) (cute/atom/mma_traits_sm90.hpp, SM90_16x8x8_F64F64F64F64_TN).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// Rows [r, r + rows) and columns [0, width) of a strided matrix into shared
// memory (row pitch `pitch` doubles) by cp.async, copier thread `ct` of
// kCopiers taking every kCopiers-th copy.  Rows at or past r_end and columns
// at or past `cols` are zero-filled.  VEC = 2 needs an even width, 16-byte
// rows and cs = 1.
template <int VEC>
__device__ __forceinline__ void copy_rows(double* s, int pitch,
                                          const double* g, int64_t rs,
                                          int64_t cs, int64_t r, int rows,
                                          int64_t r_end, int cols, int width,
                                          int ct) {
  const int per_row = width / VEC;
  const int dr = kCopiers / per_row, dc = kCopiers - dr * per_row;
  int rr = ct / per_row, cc = ct - rr * per_row;
  while (rr < rows) {
    const int64_t row = r + rr;
    const int c0 = cc * VEC;
    int valid = row < r_end ? cols - c0 : 0;
    valid = valid < 0 ? 0 : (valid > VEC ? VEC : valid);
    const double* src = valid > 0 ? g + row * rs + c0 * cs : g;
    cp_async<VEC>(s + rr * pitch + c0, src, 8 * valid);
    rr += dr;
    cc += dc;
    if (cc >= per_row) {
      cc -= per_row;
      ++rr;
    }
  }
}

// ---- kernel 3: tall Gram ---------------------------------------------------
constexpr int kGTile = 128;  // output tile edge: 8 m-tiles, up to 16 n-tiles

// NT: n-tiles a consumer holds (q-tile <= 8 NT); SETS: accumulator sets
template <int VEC, int NT, int SETS>
__global__ void __launch_bounds__(kThreads, 1)
    tall_gram_dmma(const double* __restrict__ a, int64_t as0, int64_t as1,
                   const double* __restrict__ b, int64_t bs0, int64_t bs1,
                   int64_t n, int p, int q, int64_t rows_per_chunk, int bk,
                   int pitch_a, int pitch_b, int wm_count,
                   double* __restrict__ part) {
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const int q_tiles = (q + kGTile - 1) / kGTile;
  const int p0 = (blockIdx.y / q_tiles) * kGTile;
  const int q0 = (blockIdx.y % q_tiles) * kGTile;
  const int pc = min(kGTile, p - p0), qc = min(kGTile, q - q0);
  const int mt_count = (pc + 15) / 16, nt_count = (qc + 7) / 8;
  const int64_t chunk = blockIdx.x;
  const int64_t r0 = chunk * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < n ? r0 + rows_per_chunk : n;
  const int stages = (int)((r1 - r0 + bk - 1) / bk);
  const int stage_a = bk * pitch_a;
  const int stage_len = bk * (pitch_a + pitch_b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], kCopiers);
      bar_init(&empty[s], kConsumers);
    }
  }
  __syncthreads();

  if (warp >= kConsumers) {  // producers
    const int ct = threadIdx.x - 32 * kConsumers;
    const double* a_tile = a + p0 * as1;
    const double* b_tile = b + q0 * bs1;
    for (int j = 0; j < stages; ++j) {
      const int slot = j % kStages;
      if (j >= kStages) bar_wait(&empty[slot], (j / kStages - 1) & 1);
      double* s = smem + slot * stage_len;
      const int64_t r = r0 + (int64_t)j * bk;
      copy_rows<VEC>(s, pitch_a, a_tile, as0, as1, r, bk, r1, pc,
                     16 * mt_count, ct);
      copy_rows<VEC>(s + stage_a, pitch_b, b_tile, bs0, bs1, r, bk, r1, qc,
                     8 * nt_count, ct);
      bar_arrive_copies(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % wm_count, wk = warp / wm_count;
  const int wk_count = kConsumers / wm_count;
  const bool active = wm < mt_count;
  const int ksteps = bk / 8;

  double acc[SETS][NT][4];
#pragma unroll
  for (int u = 0; u < SETS; ++u)
#pragma unroll
    for (int i = 0; i < NT; ++i)
      acc[u][i][0] = acc[u][i][1] = acc[u][i][2] = acc[u][i][3] = 0.0;

  for (int j = 0; j < stages; ++j) {
    const int slot = j % kStages;
    bar_wait(&full[slot], (j / kStages) & 1);
    if (active) {
      const double* sa = smem + slot * stage_len;
      const double* sb = sa + stage_a;
      for (int s0 = wk; s0 < ksteps; s0 += wk_count * SETS) {
#pragma unroll
        for (int u = 0; u < SETS; ++u) {
          const int s = s0 + u * wk_count;
          if (s < ksteps) {
            const double* pa = sa + (8 * s + t) * pitch_a + wm * 16 + g;
            const double a0 = pa[0], a1 = pa[8];
            const double a2 = pa[4 * pitch_a], a3 = pa[4 * pitch_a + 8];
            const double* pb = sb + (8 * s + t) * pitch_b + g;
#pragma unroll
            for (int i = 0; i < NT; ++i) {
              if (i < nt_count)
                dmma(acc[u][i], a0, a1, a2, a3, pb[8 * i],
                     pb[4 * pitch_b + 8 * i]);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
  }
#pragma unroll
  for (int u = 1; u < SETS; ++u)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][i][e] += acc[u][i][e];

  // warps that split an m-tile's k-steps add their sums in warp order; the
  // ring is free: every stage has been waited for
  if (wk_count > 1) {
    consumers_sync();
    double* red = smem;
    if (active && wk > 0) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        double* r =
            red + ((((wk - 1) * wm_count + wm) * NT + i) * 32 + lane) * 4;
        r[0] = acc[0][i][0];
        r[1] = acc[0][i][1];
        r[2] = acc[0][i][2];
        r[3] = acc[0][i][3];
      }
    }
    consumers_sync();
    if (active && wk == 0) {
      for (int w = 1; w < wk_count; ++w) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const double* r =
              red + ((((w - 1) * wm_count + wm) * NT + i) * 32 + lane) * 4;
          acc[0][i][0] += r[0];
          acc[0][i][1] += r[1];
          acc[0][i][2] += r[2];
          acc[0][i][3] += r[3];
        }
      }
    }
  }
  if (!active || wk != 0) return;
  double* out = part + chunk * (int64_t)p * q;
  const int row = p0 + wm * 16 + g;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = q0 + 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h;
      if (rr < p0 + pc) {
        if (col < q0 + qc) out[(int64_t)rr * q + col] = acc[0][i][2 * h];
        if (col + 1 < q0 + qc)
          out[(int64_t)rr * q + col + 1] = acc[0][i][2 * h + 1];
      }
    }
  }
}

// c[t] = sum over chunks of part[chunk][t], in a fixed order: lane j of an
// output adds chunks j, j + 8, ..., then lane 0 adds the eight sums in order.
__global__ void tall_gram_reduce(const double* __restrict__ part,
                                 int64_t nchunks, int64_t pq,
                                 double* __restrict__ c) {
  __shared__ double sums[8][33];
  const int o = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * 32 + o;
  double s = 0.0;
  if (t < pq)
    for (int64_t k = j; k < nchunks; k += 8) s += part[k * pq + t];
  sums[j][o] = s;
  __syncthreads();
  if (j == 0 && t < pq) {
    double r = sums[0][o];
#pragma unroll
    for (int i = 1; i < 8; ++i) r += sums[i][o];
    c[t] = r;
  }
}

// ---- kernel 4: tall expand -------------------------------------------------
constexpr int kERows = 64;   // rows of A a stage holds: 4 m-tiles
constexpr int kESlice = 40;  // columns of A a stage holds: 5 k-steps
constexpr int kEPitch = 40;  // = 8 (mod 16): a quarter warp's 16-byte loads
                             // of rows g, g + 1 hit distinct banks
constexpr int kEStage = kERows * kEPitch;

// NTW: n-tiles a consumer holds (q-tile <= 16 NTW); SETS: accumulator sets
template <int VEC, int NTW, int SETS>
__global__ void __launch_bounds__(kThreads, 1)
    tall_expand_dmma(const double* __restrict__ a, int64_t as0, int64_t as1,
                     const double* __restrict__ c, int64_t cs0, int64_t cs1,
                     int64_t n, int kc, int qc, double* __restrict__ y,
                     int64_t ys0, int accumulate) {
  extern __shared__ __align__(16) double smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const int ksteps = (kc + 7) / 8;
  const int nt_count = (qc + 7) / 8;
  // C in fragment order: the pair of step s, n-tile nt, lane (g, t) is
  // (C[8s + 2t][8nt + g], C[8s + 2t + 1][8nt + g]), zero outside C.  Each
  // thread has kCBatch pairs' loads in flight before it stores any.
  constexpr int kCBatch = 8;
  double* sc = smem;
  double* ring = smem + ksteps * nt_count * 64;
  const int pairs = ksteps * nt_count * 32;
  for (int e0 = threadIdx.x; e0 < pairs; e0 += kCBatch * kThreads) {
    double v[kCBatch][2];
#pragma unroll
    for (int u = 0; u < kCBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int l = e & 31, f = e >> 5;
      const int s = f / nt_count, nt = f - s * nt_count;
      const int col = 8 * nt + (l >> 2), k0 = 8 * s + 2 * (l & 3);
      const bool in = e < pairs && col < qc;
      v[u][0] = in && k0 < kc ? c[k0 * cs0 + col * cs1] : 0.0;
      v[u][1] = in && k0 + 1 < kc ? c[(k0 + 1) * cs0 + col * cs1] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kCBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < pairs) {
        sc[2 * e] = v[u][0];
        sc[2 * e + 1] = v[u][1];
      }
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], kCopiers);
      bar_init(&empty[s], kConsumers);
    }
  }
  __syncthreads();

  const int64_t tiles = (n + kERows - 1) / kERows;
  const int slices = (kc + kESlice - 1) / kESlice;
  const int64_t my_tiles =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int stages = (int)(my_tiles * slices);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= kConsumers) {  // producers
    const int ct = threadIdx.x - 32 * kConsumers;
    for (int j = 0; j < stages; ++j) {
      const int slot = j % kStages;
      if (j >= kStages) bar_wait(&empty[slot], (j / kStages - 1) & 1);
      const int64_t tile = blockIdx.x + (int64_t)(j / slices) * gridDim.x;
      const int k0 = (j % slices) * kESlice;
      const int cols = min(kESlice, kc - k0);
      copy_rows<VEC>(ring + slot * kEStage, kEPitch, a + k0 * as1, as0, as1,
                     tile * kERows, kERows, n, cols, 8 * ((cols + 7) / 8),
                     ct);
      bar_arrive_copies(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const bool vec_out = (ys0 & 1) == 0;
  const double2* cf = reinterpret_cast<const double2*>(sc) + lane;

  double acc[SETS][NTW][4];
#pragma unroll
  for (int u = 0; u < SETS; ++u)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
      acc[u][i][0] = acc[u][i][1] = acc[u][i][2] = acc[u][i][3] = 0.0;

  for (int j = 0; j < stages; ++j) {
    const int slot = j % kStages;
    bar_wait(&full[slot], (j / kStages) & 1);
    const int sl = j % slices;
    const int s_first = sl * (kESlice / 8);
    const int steps = (min(kESlice, kc - sl * kESlice) + 7) / 8;
    const double* pa =
        ring + slot * kEStage + (wm * 16 + g) * kEPitch + 2 * t;
    for (int s0 = 0; s0 < steps; s0 += SETS) {
#pragma unroll
      for (int u = 0; u < SETS; ++u) {
        const int s = s0 + u;
        if (s < steps) {
          const double2 lo = *reinterpret_cast<const double2*>(pa + 8 * s);
          const double2 hi =
              *reinterpret_cast<const double2*>(pa + 8 * kEPitch + 8 * s);
          const double2* bf = cf + (s_first + s) * nt_count * 32;
#pragma unroll
          for (int i = 0; i < NTW; ++i) {
            const int nt = wn + 2 * i;
            if (nt < nt_count) {
              const double2 bv = bf[nt * 32];
              dmma(acc[u][i], lo.x, hi.x, lo.y, hi.y, bv.x, bv.y);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
    if (sl == slices - 1) {  // the tile is complete: store and start over
      const int64_t tile = blockIdx.x + (int64_t)(j / slices) * gridDim.x;
      const int64_t row0 = tile * kERows + wm * 16 + g;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int nt = wn + 2 * i;
        if (nt < nt_count) {
          const int col = 8 * nt + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t row = row0 + 8 * h;
            double v0 = acc[0][i][2 * h], v1 = acc[0][i][2 * h + 1];
#pragma unroll
            for (int u = 1; u < SETS; ++u) {
              v0 += acc[u][i][2 * h];
              v1 += acc[u][i][2 * h + 1];
            }
            if (row < n && col < qc) {
              double* dst = y + row * ys0 + col;
              if (vec_out && col + 1 < qc) {
                double2* d2 = reinterpret_cast<double2*>(dst);
                if (accumulate) {
                  const double2 old = *d2;
                  v0 += old.x;
                  v1 += old.y;
                }
                *d2 = make_double2(v0, v1);
              } else {
                dst[0] = accumulate ? dst[0] + v0 : v0;
                if (col + 1 < qc) dst[1] = accumulate ? dst[1] + v1 : v1;
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < SETS; ++u)
          acc[u][i][0] = acc[u][i][1] = acc[u][i][2] = acc[u][i][3] = 0.0;
      }
    }
  }
}

// One 16 x 8 x 8 tile through dmma(), fragments read straight from device
// memory: the check of the fragment layout the two kernels rely on.
__global__ void dmma_tile_check(const double* __restrict__ a,
                                const double* __restrict__ b,
                                double* __restrict__ d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  dmma(acc, a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + t + 4],
       a[(g + 8) * 8 + t + 4], b[t * 8 + g], b[(t + 4) * 8 + g]);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, set once per kernel and device
// (the static barriers take a little of the block's 232,448 bytes)
constexpr int kMaxDevices = 64;
constexpr int kMaxDynamicSmem = 232448 - 1024;

template <typename Kernel>
int allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (err == 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int VEC, int NT, int SETS>
int launch_gram(dim3 grid, int64_t smem, cudaStream_t s, const double* a,
                int64_t as0, int64_t as1, const double* b, int64_t bs0,
                int64_t bs1, int64_t n, int p, int q, int64_t rows, int bk,
                int pitch_a, int pitch_b, int wm, double* part) {
  static bool done[kMaxDevices];
  int err = allow_smem(tall_gram_dmma<VEC, NT, SETS>, done);
  if (err != 0) return err;
  tall_gram_dmma<VEC, NT, SETS><<<grid, kThreads, smem, s>>>(
      a, as0, as1, b, bs0, bs1, n, p, q, rows, bk, pitch_a, pitch_b, wm,
      part);
  return (int)cudaGetLastError();
}

template <int VEC, int NTW, int SETS>
int launch_expand(int64_t grid, int64_t smem, cudaStream_t s,
                  const double* a, int64_t as0, int64_t as1, const double* c,
                  int64_t cs0, int64_t cs1, int64_t n, int kc, int qc,
                  double* y, int64_t ys0, int accumulate) {
  static bool done[kMaxDevices];
  int err = allow_smem(tall_expand_dmma<VEC, NTW, SETS>, done);
  if (err != 0) return err;
  tall_expand_dmma<VEC, NTW, SETS><<<(unsigned)grid, kThreads, smem, s>>>(
      a, as0, as1, c, cs0, cs1, n, kc, qc, y, ys0, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// C = A^T B: grid (chunks, output tiles), then the chunk sum.  `nt`: n-tiles
// of the widest q-tile (2, 4, 8 or 16), which picks the instance.
extern "C" int gcge_tall_gram_f64(const void* a, int64_t as0, int64_t as1,
                                  const void* b, int64_t bs0, int64_t bs1,
                                  int64_t n, int64_t p, int64_t q,
                                  int64_t nchunks, int64_t rows_per_chunk,
                                  int64_t bk, int64_t pitch_a,
                                  int64_t pitch_b, int64_t wm_count,
                                  int64_t nt, int64_t smem, int64_t vec,
                                  void* part, void* c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles =
      ((p + kGTile - 1) / kGTile) * ((q + kGTile - 1) / kGTile);
  const dim3 grid((unsigned)nchunks, (unsigned)tiles);
  const double* ad = (const double*)a;
  const double* bd = (const double*)b;
  double* pd = (double*)part;
#define GCGE_GRAM(V, NT, SETS)                                               \
  launch_gram<V, NT, SETS>(grid, smem, s, ad, as0, as1, bd, bs0, bs1, n,     \
                           (int)p, (int)q, rows_per_chunk, (int)bk,          \
                           (int)pitch_a, (int)pitch_b, (int)wm_count, pd)
  int err;
  if (vec == 2)
    err = nt <= 2   ? GCGE_GRAM(2, 2, 4)
          : nt <= 4 ? GCGE_GRAM(2, 4, 2)
          : nt <= 8 ? GCGE_GRAM(2, 8, 1)
                    : GCGE_GRAM(2, 16, 1);
  else
    err = nt <= 2   ? GCGE_GRAM(1, 2, 4)
          : nt <= 4 ? GCGE_GRAM(1, 4, 2)
          : nt <= 8 ? GCGE_GRAM(1, 8, 1)
                    : GCGE_GRAM(1, 16, 1);
#undef GCGE_GRAM
  if (err != 0) return err;
  const int64_t pq = p * q;
  tall_gram_reduce<<<(unsigned)((pq + 31) / 32), 256, 0, s>>>(pd, nchunks, pq,
                                                              (double*)c);
  return (int)cudaGetLastError();
}

// Y = A C over the plan's q-tiles and k-chunks: q_tile columns of Y and C a
// launch, k_chunk rows of C; later k-chunks add into Y, in order.  `nt`:
// n-tiles of the widest q-tile, which picks the instance (32 accumulators a
// thread in each).
extern "C" int gcge_tall_expand_f64(const void* a, int64_t as0, int64_t as1,
                                    const void* c, int64_t cs0, int64_t cs1,
                                    int64_t n, int64_t k, int64_t q,
                                    int64_t q_tile, int64_t k_chunk,
                                    int64_t nt, int64_t grid, int64_t smem,
                                    int64_t vec, void* y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const double* ad = (const double*)a;
  const double* cd = (const double*)c;
  double* yd = (double*)y;
  for (int64_t q0 = 0; q0 < q; q0 += q_tile) {
    const int qc = (int)(q - q0 < q_tile ? q - q0 : q_tile);
    for (int64_t k0 = 0; k0 < k; k0 += k_chunk) {
      const int kc = (int)(k - k0 < k_chunk ? k - k0 : k_chunk);
#define GCGE_EXPAND(V, NTW, SETS)                                            \
  launch_expand<V, NTW, SETS>(grid, smem, s, ad + k0 * as1, as0, as1,        \
                              cd + k0 * cs0 + q0 * cs1, cs0, cs1, n, kc, qc, \
                              yd + q0, q, k0 > 0)
      int err;
      if (vec == 2)
        err = nt <= 2   ? GCGE_EXPAND(2, 1, 8)
              : nt <= 4 ? GCGE_EXPAND(2, 2, 4)
              : nt <= 8 ? GCGE_EXPAND(2, 4, 2)
                        : GCGE_EXPAND(2, 8, 1);
      else
        err = nt <= 2   ? GCGE_EXPAND(1, 1, 8)
              : nt <= 4 ? GCGE_EXPAND(1, 2, 4)
              : nt <= 8 ? GCGE_EXPAND(1, 4, 2)
                        : GCGE_EXPAND(1, 8, 1);
#undef GCGE_EXPAND
      if (err != 0) return err;
    }
  }
  return 0;
}

extern "C" int gcge_dmma_tile_check(const void* a, const void* b, void* d,
                                    void* stream) {
  dmma_tile_check<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const double*)a, (const double*)b, (double*)d);
  return (int)cudaGetLastError();
}
