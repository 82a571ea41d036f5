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

#include <type_traits>

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

// ---- the wide path of kernels 3 and 4 ---------------------------------------
// For the classes of the production widths with both sides wide (a p, q or
// k above 128 and the other at least 64: the (880 x 80) to (960 x 800)
// products of nev = 400, (400 x 400) and (480 x 400) of nev = 200), which
// are bound by their f64 operations or by bytes too wide for the resident
// designs above.  A block multiplies one kBM x kBN output tile with WM x WN
// warps of MT x NT m16n8k8 mma tiles (a warp's m-tiles wm, wm + WM, ...,
// its n-tiles wn, wn + WN, ...: a ragged last tile leaves every warp a
// share, and tiles past the operand are skipped whole), accumulators in
// registers across the whole contraction; each A fragment feeds NT mmas,
// each B fragment MT.  All threads copy (cp.async, 16 bytes where VEC = 2,
// with a per-thread plan computed once: StageCopy) into a STAGES-deep ring
// of k-slices of K, and all multiply; MINB blocks share an SM.
//
// The tensor pipe is fed from registers without a gap: a warp loads the
// fragments of its next k-step while the mmas of this one run (B into the
// other of two buffers, A m-tile by m-tile right after the mmas that read
// it), and the ring has no block-wide barrier (wide_loop).  What holds this
// loop on the H100 is neither the f64 mma rate (mma.sync reaches its peak
// from registers with a few warps an SM) nor the copy rate from L2, but the
// latency of copies and fragment loads that 8 warps an SM do not hide, so
// the loop has no __syncthreads (a block-wide barrier a slice stalls every
// warp on the slowest) and the copies a per-thread plan (a general row walk
// spends the issue slots the mmas need).  Blocks of 2 x 2 warps (the
// shapes cuBLAS's DGEMM takes here, several blocks an SM) and blocks of 16
// warps of 2 x 4 mma tiles (which spill) measured slower than this block
// at every class.
//
// Blocks are not persistent: the hardware hands a block to the SM that
// frees first, which evens out tiles of unequal size, and consecutive
// blocks share an operand band in L2 (expand: the q-tiles of one row band
// of A; Gram: the p- and q-tiles of one chunk of rows).
//
// Shared memory (bank-conflict free):
//   expand, A stage [kBM rows][kPitchA]: a thread reads 16 bytes (k = 2t,
//     2t + 1 of its row, the same map as kernel 4 above); kPitchA = 8 (mod
//     16) puts rows g and g + 1 of a quarter warp on distinct banks;
//   [K rows][kPitchM or kPitchN] for the Gram's A and B and the expand's C:
//     a thread reads rows 2t and 2t + 1 of its column g, 8 bytes each; a
//     pitch = 2 (mod 8) puts the 16 lanes of a half warp on distinct banks.
template <int WM, int WN, int MT, int NT, int K, int STAGES, int MINB>
struct Wide {
  static constexpr int kWM = WM, kWN = WN, kMT = MT, kNT = NT;
  static constexpr int kK = K, kStages = STAGES, kMinBlocks = MINB;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kBM = 16 * MT * WM;  // rows of the output tile
  static constexpr int kBN = 8 * NT * WN;   // its columns
  static constexpr int kSteps = K / 8;
  static constexpr int kPitchA = K + 8;
  static constexpr int kPitchM = kBM + 2;
  static constexpr int kPitchN = kBN + 2;
  static constexpr int kStageA = kBM * kPitchA;  // doubles, expand
  // C's stage: [K][kPitchN], or [kBN][K] for a column-major C
  static constexpr int kStageC = K * kPitchN > kBN * K ? K * kPitchN : kBN * K;
  static constexpr int kStageGram = K * (kPitchM + kPitchN);
  static constexpr int kSmemExpand = 8 * STAGES * (kStageA + kStageC);
  static constexpr int kSmemGram = 8 * STAGES * kStageGram;
  static_assert(kSteps % 2 == 0, "B fragments alternate by k-step parity");
  static_assert(kPitchA % 16 == 8 && kPitchM % 8 == 2 && kPitchN % 8 == 2,
                "conflict-free pitches");
};

// the block both wide kernels launch (osgemm.WIDE): 8 warps of 4 x 4 mma
// tiles over a 128 x 128 tile, k-slices of 32 through 3 stages (222,720
// bytes), one block an SM
using WideShape = Wide<2, 4, 4, 4, 32, 3, 1>;

// The copies of one operand's stage, [ROWS][WIDTH] doubles at row pitch
// PITCH, from a strided source: thread tid of THREADS copies chunk
// tid % kPerRow of VEC doubles of rows tid / kPerRow + i kRowStep.  The
// thread's source and shared address are computed once; a stage then costs
// a few instructions a copy (a general row walk with 64-bit index
// arithmetic takes tens).  SWZ: the
// 16-byte chunk c of row r lands at chunk c ^ 4 (r & 1), so that rows g and
// g + 1 of a quarter warp read distinct banks without a padded pitch.
template <int VEC, int THREADS, int ROWS, int WIDTH, int PITCH,
          bool SWZ = false>
struct StageCopy {
  static constexpr int kPerRow = WIDTH / VEC;
  static constexpr int kRowStep = THREADS / kPerRow;
  static constexpr int kPasses = ROWS / kRowStep;
  static_assert(THREADS % kPerRow == 0 && ROWS % kRowStep == 0,
                "a stage is whole passes of the block");
  static_assert(!SWZ || (VEC == 2 && kRowStep % 2 == 0 && WIDTH % 16 == 0),
                "a swizzled row keeps its parity across passes");
  const double* src;  // the thread's first chunk, at shift 0
  unsigned dst;       // its shared address in ring slot 0

  __device__ __forceinline__ StageCopy(const double* g, int64_t rs,
                                       int64_t cs, const double* ring) {
    const int row = threadIdx.x / kPerRow;
    const int col = (threadIdx.x % kPerRow) * VEC;
    src = g + row * rs + col * cs;
    dst = smem_u32(ring + row * PITCH +
                   (SWZ ? ((col >> 1) ^ ((row & 1) << 2)) << 1 : col));
  }

  // the stage at src + shift into the slot `slot_bytes` past slot 0; rows
  // at or past rows_valid and columns at or past cols_valid are zeros
  __device__ __forceinline__ void operator()(int64_t shift, int64_t rs,
                                             unsigned slot_bytes,
                                             int rows_valid,
                                             int cols_valid) const {
    const int row = threadIdx.x / kPerRow;
    int valid = cols_valid - (int)(threadIdx.x % kPerRow) * VEC;
    valid = valid < 0 ? 0 : (valid > VEC ? VEC : valid);
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int bytes = row + i * kRowStep < rows_valid ? 8 * valid : 0;
      const double* s = src + shift + (int64_t)(i * kRowStep) * rs;
      const unsigned d = dst + slot_bytes + i * kRowStep * PITCH * 8;
      if (VEC == 2)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         d),
                     "l"(bytes ? s : src), "r"(bytes)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                         d),
                     "l"(bytes ? s : src), "r"(bytes)
                     : "memory");
    }
  }
};

// The main loop of both wide kernels over `slices` k-slices.  copy(j, slot)
// issues this thread's cp.async copies of slice j into ring slot `slot`;
// load_a(slot, step, i, a) and load_b(slot, step, b) read a warp's
// fragments of k-step `step` of the slot.  No block-wide barrier: each
// slot has a full barrier (every thread's copies landed) and an empty one
// (every warp past its reads), and a thread refills the slot of slice j - 1
// with slice j + STAGES - 1 during slice j, so warps drift apart by up to
// a slice.  The copies issue in the last k-step of a slice, after its
// first NT mmas.
template <class S, class Copy, class LoadA, class LoadB>
__device__ __forceinline__ void wide_loop(int slices, int mt_live,
                                          int nt_live, Copy copy,
                                          LoadA load_a, LoadB load_b,
                                          double (&acc)[S::kMT][S::kNT][4]) {
  __shared__ uint64_t full[S::kStages], empty[S::kStages];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      bar_init(&full[s], S::kThreads);
      bar_init(&empty[s], S::kThreads / 32);
    }
  }
  __syncthreads();
  auto fill = [&](int j) {  // slice j into slot j % kStages
    const int slot = j % S::kStages;
    if (j >= S::kStages) bar_wait(&empty[slot], (j / S::kStages - 1) & 1);
    copy(j, slot);
    bar_arrive_copies(&full[slot]);
  };
  double fa[S::kMT][4], fb[2][S::kNT][2];
#pragma unroll
  for (int j = 0; j < S::kStages - 1; ++j)
    if (j < slices) fill(j);
  bar_wait(&full[0], 0);
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
    if (i < mt_live) load_a(0, 0, i, fa[i]);
  load_b(0, 0, fb[0]);
  for (int j = 0; j < slices; ++j) {
    const int slot = j % S::kStages;
#pragma unroll
    for (int s = 0; s < S::kSteps; ++s) {
      int next_slot = slot, next_step = s + 1;
      const bool more = s < S::kSteps - 1 || j + 1 < slices;
      if (s == S::kSteps - 1) {
        // this warp is past its reads of slot j; slice j + 1 must be in
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[slot]);
        next_slot = (j + 1) % S::kStages;
        next_step = 0;
        if (more) bar_wait(&full[next_slot], ((j + 1) / S::kStages) & 1);
      }
      if (more) load_b(next_slot, next_step, fb[(s + 1) & 1]);
#pragma unroll
      for (int i = 0; i < S::kMT; ++i) {
        if (i < mt_live) {
#pragma unroll
          for (int jn = 0; jn < S::kNT; ++jn)
            if (jn < nt_live)
              dmma(acc[i][jn], fa[i][0], fa[i][1], fa[i][2], fa[i][3],
                   fb[s & 1][jn][0], fb[s & 1][jn][1]);
          if (more) load_a(next_slot, next_step, i, fa[i]);
        }
        if (s == S::kSteps - 1 && i == 0 && j + S::kStages - 1 < slices)
          fill(j + S::kStages - 1);
      }
    }
  }
}

// Stores a warp's accumulators into rows r0 + (m-tile rows) below r_end and
// columns c0 + (n-tile columns) below c_end of out (row pitch `ld`, 16-byte
// stores where ld is even).
template <class S>
__device__ __forceinline__ void wide_store(
    const double (&acc)[S::kMT][S::kNT][4], double* __restrict__ out,
    int64_t ld, int64_t r0, int64_t r_end, int c0, int c_end, int wm,
    int wn, int g, int t) {
  const bool vec_out = (ld & 1) == 0;
#pragma unroll
  for (int i = 0; i < S::kMT; ++i) {
#pragma unroll
    for (int jn = 0; jn < S::kNT; ++jn) {
      const int col = c0 + (wn + S::kWN * jn) * 8 + 2 * t;
      if (col >= c_end) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = r0 + (wm + S::kWM * i) * 16 + g + 8 * h;
        if (row >= r_end) continue;
        double* dst = out + row * ld + col;
        if (vec_out && col + 1 < c_end) {
          *reinterpret_cast<double2*>(dst) =
              make_double2(acc[i][jn][2 * h], acc[i][jn][2 * h + 1]);
        } else {
          dst[0] = acc[i][jn][2 * h];
          if (col + 1 < c_end) dst[1] = acc[i][jn][2 * h + 1];
        }
      }
    }
  }
}

// tiles of a warp below `count` tiles of the block: w, w + WARPS, ...
template <int WARPS, int MAX>
__device__ __forceinline__ int live_tiles(int count, int w) {
  const int live = (count - w + WARPS - 1) / WARPS;
  return live < 0 ? 0 : (live > MAX ? MAX : live);
}

// Y = A C for the output tile (row band, q-tile) of block x (q-tiles
// fastest), over all of k; band <= kBM, q_tile <= kBN.  VEC: A's copies.
// C_MODE: 1, C's rows start on 16 bytes and are contiguous (16-byte copies
// into [K][kPitchN]); 2, C is column-major with columns on 16 bytes (as
// eigh returns its eigenvectors: 16-byte copies of C's columns into a
// swizzled [kBN][K] stage, and one 16-byte load a B fragment); 0, any
// strides (8-byte copies into [K][kPitchN]).
template <int VEC, int C_MODE, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
    tall_expand_wide(const double* __restrict__ a, int64_t as0, int64_t as1,
                     const double* __restrict__ c, int64_t cs0, int64_t cs1,
                     int64_t n, int k, int q, int band, int q_tile,
                     double* __restrict__ y) {
  extern __shared__ __align__(16) double smem[];
  double* ring_a = smem;
  double* ring_c = smem + S::kStages * S::kStageA;
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const int64_t r0 = (int64_t)(blockIdx.x / q_tiles) * band;
  const int q0 = (int)(blockIdx.x % q_tiles) * q_tile;
  const int rows = (int)(n - r0 < band ? n - r0 : band);
  const int qc = min(q_tile, q - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % S::kWM, wn = warp / S::kWM;
  const int nt_count = (qc + 7) / 8;

  const StageCopy<VEC, S::kThreads, S::kBM, S::kK, S::kPitchA> copy_a(
      a + r0 * as0, as0, as1, ring_a);
  using CopyC = std::conditional_t<
      C_MODE == 2, StageCopy<2, S::kThreads, S::kBN, S::kK, S::kK, true>,
      StageCopy<C_MODE == 1 ? 2 : 1, S::kThreads, S::kK, S::kBN,
                S::kPitchN>>;
  // a column-major C is copied as C^T, whose rows are C's columns
  const int64_t c_rows = C_MODE == 2 ? cs1 : cs0;
  const CopyC copy_c(c + q0 * cs1, c_rows, C_MODE == 2 ? cs0 : cs1, ring_c);
  auto copy = [&](int j, int slot) {
    const int k0 = j * S::kK, kc = min(S::kK, k - k0);
    copy_a(k0 * as1, as0, slot * S::kStageA * 8, rows, kc);
    if (C_MODE == 2)
      copy_c(k0 * cs0, c_rows, slot * S::kStageC * 8, qc, kc);
    else
      copy_c(k0 * cs0, c_rows, slot * S::kStageC * 8, kc, qc);
  };
  auto load_a = [&](int slot, int s, int i, double (&fa)[4]) {
    const double* pa = ring_a + slot * S::kStageA +
                       ((wm + S::kWM * i) * 16 + g) * S::kPitchA + 8 * s +
                       2 * t;
    const double2 lo = *reinterpret_cast<const double2*>(pa);
    const double2 hi =
        *reinterpret_cast<const double2*>(pa + 8 * S::kPitchA);
    fa[0] = lo.x;
    fa[1] = hi.x;
    fa[2] = lo.y;
    fa[3] = hi.y;
  };
  auto load_b = [&](int slot, int s, double (&fb)[S::kNT][2]) {
    if (C_MODE == 2) {  // row n of C^T, chunk 4s + t (k = 8s + 2t, + 1)
      const double* pb = ring_c + slot * S::kStageC + (wn * 8 + g) * S::kK +
                         (((4 * s + t) ^ ((g & 1) << 2)) << 1);
#pragma unroll
      for (int jn = 0; jn < S::kNT; ++jn) {
        if (wn + S::kWN * jn < nt_count) {
          const double2 v = *reinterpret_cast<const double2*>(
              pb + 8 * S::kWN * jn * S::kK);
          fb[jn][0] = v.x;
          fb[jn][1] = v.y;
        }
      }
    } else {
      const double* pb = ring_c + slot * S::kStageC +
                         (8 * s + 2 * t) * S::kPitchN + wn * 8 + g;
#pragma unroll
      for (int jn = 0; jn < S::kNT; ++jn) {
        if (wn + S::kWN * jn < nt_count) {
          fb[jn][0] = pb[8 * S::kWN * jn];
          fb[jn][1] = pb[8 * S::kWN * jn + S::kPitchN];
        }
      }
    }
  };

  double acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0;
  wide_loop<S>((k + S::kK - 1) / S::kK,
               live_tiles<S::kWM, S::kMT>((rows + 15) / 16, wm),
               live_tiles<S::kWN, S::kNT>(nt_count, wn), copy, load_a,
               load_b, acc);
  wide_store<S>(acc, y, q, r0, r0 + rows, q0, q0 + qc, wm, wn, g, t);
}

// The partial C = A^T B of one chunk of rows for the output tile (p-tile,
// q-tile) of block x (tiles fastest), into part[chunk]; tall_gram_reduce
// adds the chunks in order.
template <int VEC, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
    tall_gram_wide(const double* __restrict__ a, int64_t as0, int64_t as1,
                   const double* __restrict__ b, int64_t bs0, int64_t bs1,
                   int64_t n, int p, int q, int64_t rows_per_chunk,
                   double* __restrict__ part) {
  extern __shared__ __align__(16) double smem[];
  const int q_tiles = (q + S::kBN - 1) / S::kBN;
  const int tiles = ((p + S::kBM - 1) / S::kBM) * q_tiles;
  const int64_t chunk = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int p0 = (tile / q_tiles) * S::kBM, q0 = (tile % q_tiles) * S::kBN;
  const int pc = min(S::kBM, p - p0), qc = min(S::kBN, q - q0);
  const int64_t r0 = chunk * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < n ? r0 + rows_per_chunk : n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % S::kWM, wn = warp / S::kWM;
  const int nt_count = (qc + 7) / 8;
  double* ring_b = smem + S::kK * S::kPitchM;

  const StageCopy<VEC, S::kThreads, S::kK, S::kBM, S::kPitchM> copy_a(
      a + p0 * as1 + r0 * as0, as0, as1, smem);
  const StageCopy<VEC, S::kThreads, S::kK, S::kBN, S::kPitchN> copy_b(
      b + q0 * bs1 + r0 * bs0, bs0, bs1, ring_b);
  auto copy = [&](int j, int slot) {
    const int64_t r = (int64_t)j * S::kK;
    const int rows = (int)(r1 - r0 - r < S::kK ? r1 - r0 - r : S::kK);
    copy_a(r * as0, as0, slot * S::kStageGram * 8, rows, pc);
    copy_b(r * bs0, bs0, slot * S::kStageGram * 8, rows, qc);
  };
  auto load_a = [&](int slot, int s, int i, double (&fa)[4]) {
    const double* pa = smem + slot * S::kStageGram +
                       (8 * s + 2 * t) * S::kPitchM +
                       (wm + S::kWM * i) * 16 + g;
    fa[0] = pa[0];
    fa[1] = pa[8];
    fa[2] = pa[S::kPitchM];
    fa[3] = pa[S::kPitchM + 8];
  };
  auto load_b = [&](int slot, int s, double (&fb)[S::kNT][2]) {
    const double* pb = ring_b + slot * S::kStageGram +
                       (8 * s + 2 * t) * S::kPitchN + wn * 8 + g;
#pragma unroll
    for (int jn = 0; jn < S::kNT; ++jn) {
      if (wn + S::kWN * jn < nt_count) {
        fb[jn][0] = pb[8 * S::kWN * jn];
        fb[jn][1] = pb[8 * S::kWN * jn + S::kPitchN];
      }
    }
  };

  double acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0;
  wide_loop<S>((int)((r1 - r0 + S::kK - 1) / S::kK),
               live_tiles<S::kWM, S::kMT>((pc + 15) / 16, wm),
               live_tiles<S::kWN, S::kNT>(nt_count, wn), copy, load_a,
               load_b, acc);
  wide_store<S>(acc, part + chunk * (int64_t)p * q, q, p0, p0 + pc, q0,
                q0 + qc, wm, wn, g, t);
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

// an SM's 233,472 bytes of shared memory, 1 KB of it kept for each block
static_assert(WideShape::kMinBlocks * (WideShape::kSmemExpand + 1024) <=
                      233472 &&
                  WideShape::kSmemExpand <= kMaxDynamicSmem,
              "the wide rings of kMinBlocks blocks fit an SM");

template <int VEC>
int launch_gram_wide(int64_t blocks, cudaStream_t s, const double* a,
                     int64_t as0, int64_t as1, const double* b, int64_t bs0,
                     int64_t bs1, int64_t n, int p, int q, int64_t rows,
                     double* part) {
  static bool done[kMaxDevices];
  int err = allow_smem(tall_gram_wide<VEC, WideShape>, done);
  if (err != 0) return err;
  tall_gram_wide<VEC, WideShape>
      <<<(unsigned)blocks, WideShape::kThreads, WideShape::kSmemGram, s>>>(
          a, as0, as1, b, bs0, bs1, n, p, q, rows, part);
  return (int)cudaGetLastError();
}

template <int VEC, int C_MODE>
int launch_expand_wide(int64_t blocks, cudaStream_t s, const double* a,
                       int64_t as0, int64_t as1, const double* c, int64_t cs0,
                       int64_t cs1, int64_t n, int k, int q, int band,
                       int q_tile, double* y) {
  static bool done[kMaxDevices];
  int err = allow_smem(tall_expand_wide<VEC, C_MODE, WideShape>, done);
  if (err != 0) return err;
  tall_expand_wide<VEC, C_MODE, WideShape>
      <<<(unsigned)blocks, WideShape::kThreads, WideShape::kSmemExpand, s>>>(
          a, as0, as1, c, cs0, cs1, n, k, q, band, q_tile, y);
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

// The wide path of C = A^T B: chunks x tiles blocks of WideShape's kBM x
// kBN, then the chunk sum in chunk order.
extern "C" int gcge_tall_gram_wide_f64(const void* a, int64_t as0,
                                       int64_t as1, const void* b,
                                       int64_t bs0, int64_t bs1, int64_t n,
                                       int64_t p, int64_t q, int64_t nchunks,
                                       int64_t rows_per_chunk, int64_t vec,
                                       void* part, void* c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t blocks = nchunks *
                         ((p + WideShape::kBM - 1) / WideShape::kBM) *
                         ((q + WideShape::kBN - 1) / WideShape::kBN);
  const double* ad = (const double*)a;
  const double* bd = (const double*)b;
  double* pd = (double*)part;
  const int err =
      vec == 2 ? launch_gram_wide<2>(blocks, s, ad, as0, as1, bd, bs0, bs1, n,
                                     (int)p, (int)q, rows_per_chunk, pd)
               : launch_gram_wide<1>(blocks, s, ad, as0, as1, bd, bs0, bs1, n,
                                     (int)p, (int)q, rows_per_chunk, pd);
  if (err != 0) return err;
  const int64_t pq = p * q;
  tall_gram_reduce<<<(unsigned)((pq + 31) / 32), 256, 0, s>>>(pd, nchunks, pq,
                                                              (double*)c);
  return (int)cudaGetLastError();
}

// The wide path of Y = A C: one launch, a block for each (row band, q-tile)
// of Y, q-tiles fastest; Y written once.  vec: A's copies; c_mode: C's
// layout (tall_expand_wide).
extern "C" int gcge_tall_expand_wide_f64(const void* a, int64_t as0,
                                         int64_t as1, const void* c,
                                         int64_t cs0, int64_t cs1, int64_t n,
                                         int64_t k, int64_t q, int64_t band,
                                         int64_t q_tile, int64_t vec,
                                         int64_t c_mode, void* y,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t blocks = ((n + band - 1) / band) * ((q + q_tile - 1) / q_tile);
  const double* ad = (const double*)a;
  const double* cd = (const double*)c;
  double* yd = (double*)y;
#define GCGE_EXPAND_WIDE(V, M)                                                \
  launch_expand_wide<V, M>(blocks, s, ad, as0, as1, cd, cs0, cs1, n, (int)k, \
                           (int)q, (int)band, (int)q_tile, yd)
  int err;
  if (vec == 2)
    err = c_mode == 2   ? GCGE_EXPAND_WIDE(2, 2)
          : c_mode == 1 ? GCGE_EXPAND_WIDE(2, 1)
                        : GCGE_EXPAND_WIDE(2, 0);
  else
    err = c_mode == 2   ? GCGE_EXPAND_WIDE(1, 2)
          : c_mode == 1 ? GCGE_EXPAND_WIDE(1, 1)
                        : GCGE_EXPAND_WIDE(1, 0);
#undef GCGE_EXPAND_WIDE
  return err;
}

extern "C" int gcge_dmma_tile_check(const void* a, const void* b, void* d,
                                    void* stream) {
  dmma_tile_check<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const double*)a, (const double*)b, (double*)d);
  return (int)cudaGetLastError();
}
