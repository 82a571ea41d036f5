// Irregular (CSR) sparse matrix times multivector on Hopper (kernels 5 and 6
// of the port).
//
//   y[i, j] = sum_{p = rowptr[i]}^{rowptr[i+1]-1} values[p] * x[colidx[p], j]
//
// Replaces gcge_tpu/ops/onehot_pallas.py:_onehot_spmm_t (f32: per packed
// (row-tile, column-window) pair two MXU products against one-hot select and
// scatter matrices built in the kernel, because the TPU has no gather) and
// :_onehot_spmm_t_df64 (the same product to ~2^-40 relative from bf16 planes,
// Dekker products and integer-slice scatters, because the TPU has no f64).
// Hopper has a gather and native f64, so neither the pairs nor the planes are
// carried over: both kernels work on plain CSR, in T, with no atomics.  Two
// launches on the same inputs give the same bits, and so does a row wherever
// it sits: how its sum is split and ordered depends on its length, m and T
// alone, never on the rows around it or on the layout of x and y, so a block
// of rows gives the same bits in the whole matrix and as a rank's shard.  x
// and y are logical (n_cols, m) and (n, m) matrices given by 2-D strides, so
// both serve the row-major (n, m) layout of CsrOperator.matvec and the
// transposed (m, n) layout of matvec_t, views included, without a copy.
//
// Kernel 5, csr_spmm_f32: the f32 product of the mixed inner CG, whose
//   operand is (m, n) in shape and (n, m) in memory: a row of the logical x,
//   one m-float record, is contiguous.
// Kernel 6, csr_spmm_f64: every f64 application of a CSR operator in a
//   solve: the W coupling of each Rayleigh-Ritz step on the column view
//   V[:, size_x + bs:] (rows 120 doubles apart), the residual window (an odd
//   column offset: rows 8-byte aligned only), the initial Rayleigh-Ritz at
//   m = 100, the inner solve's f64 refresh, and the AMG V-cycle's products on
//   the coarse levels and transfers (an (n, 10) block).
//
// What bounds both on this card: device memory.  A product reads each entry
// once, 12 B in f64 (8 of values, 4 of colidx) and 8 B in f32, plus rowptr,
// x and y once each, for 2 flops an entry and column: at the irregular
// slice's shape (n = 250,047, nnz = 4,004,065, m = 10) 48 MB of entries, 1 MB
// of rowptr and 20 MB each of x and y in f64 (26.6 us at 3.35 TB/s; f32
// 15.8 us), at AMG level 2 (17,588 rows of 400-1,289 entries, 12.86 M
// entries) 154 MB (47 us).  The gathered records of x (80 B an entry in f64
// at m = 10) come from L2 and L1: x fits the 50 MB L2 at every solve operand.
//
// The plan (onehot.csr_plan, built once per matrix on the host) sorts each
// row by its own length: rows of at most CSR_SPLIT (256) entries go to row
// tiles, longer ones to the split list.  One launch runs both: blocks
// [0, nsplit) the split list, longest rows first, the rest the tiles; both
// write disjoint rows of y.
//   * Tile path (the Delaunay matrix's ~16-entry rows, the AMG transfers and
//     level 1).  Block b owns the whole rows [tiles[2b], tiles[2b+1]), whose
//     entries, widened to 16-byte boundaries, fit `budget` entries (1,024:
//     8 KB in f32, 12 KB in f64).  It copies them into shared memory with
//     16-byte cp.async copies (one-element copies where an array does not
//     start on 16 bytes), so each byte of the matrix crosses from device
//     memory once, not once per output column.  Thread t then takes the
//     items t, t + kThreads, ... of the tile's (row, column group) pairs,
//     VEC elements (16 bytes or one) a group, and carries its item through
//     the row in CSR order, one fused multiply-add a term, kBatch gathers in
//     flight before it adds them.  The column group runs fastest, unless y's
//     rows are adjacent (a transposed layout): then the row does.  Operands
//     of more than onehot.CSR_WIDE_M columns run on the wide path's tiles
//     (at most 512 entries and 32 rows: the same kernel, the same bits),
//     which measured 3-23 % faster there and slower at m = 10 and 20.  What
//     holds it (found by leaving parts out; PERF.md): at the irregular
//     matrix's m = 10 operands and at its nev=200 operands (m = 40) the
//     gathers of x take about a third of the time (aimed at two records,
//     the CG's (40, n) ran 0.063 against 0.093 ms on the H100), and they
//     reach L2 at about once per distinct record of a tile: L1 already
//     holds a tile's reuse.  So staging each tile's distinct records in
//     shared memory first measured slower at every operand (one block a
//     tile and column slab, and a persistent grid in two stages; copies
//     by cp.async and by the bulk copy engine; 64 to 1,024 threads; tiles
//     of 32 to 128 rows and at most 384 distinct columns): the copies
//     alone took about as long as the whole tile path, and so did the
//     products from shared memory alone.  Also no faster at m = 10: 4 or
//     16 gathers in flight, 512 threads, other budgets.
//   * Split path (the AMG coarse levels' rows of 400-2,449 entries).  On the
//     tile path a 1,024-entry tile held one or two such rows: m / VEC items
//     (5 at m = 10 in f64) for a block of 256 threads, each a chain of up to
//     1,289 dependent gathers, and a row past the budget was a tile of its
//     own, restaged in 1,024-entry chunks with a barrier each: 20-30 times
//     the bound, slower than torch.sparse.mm.  Now a row gets whole blocks:
//     ceil(len / CSR_PART) parts of equal length (CSR_PART = 2,048), a block
//     each.  A part's entries split into kWarps contiguous ranges, one a
//     warp.  In a warp, G = min(m / LV, 32) lanes share an entry, lane g
//     gathering columns [g LV, g LV + LV) of its record (LV = 2 in f64, 4 or
//     2 in f32, 1 where m is odd: a function of m and T, loaded VEC at a
//     time), and E = 32 / G entry slots run side by side, slot s taking the
//     range's entries s, s + E, ... in order, kSplitBatch in flight.  colidx
//     and values are read straight from device memory, coalesced across the
//     slots, each entry once; only where a warp holds one slot (m / LV > 16:
//     each lane then walks a long chain) does the launch pick the kernel
//     that first stages the part in shared memory, as a tile is, which
//     spares each batch a dependent round trip, and keeps kBatch gathers in
//     flight (staged_split).  The slots' sums are added by a fixed shuffle
//     tree, the warps' in warp order through shared memory, and a row of
//     several parts has its parts' sums added in part order by a second
//     launch (csr_combine) from a scratch buffer.  A larger m walks slabs
//     of 32 column groups.  What holds it at
//     AMG level 2: the 80-byte records of x that every entry gathers, 1 GB a
//     call, mostly from L2 (about 5 TB/s of them at the measured 0.20 ms).
//     At PAS's m = 75 (600-byte records, 7.7 GB of them a call at level 2)
//     the same: the staged kernel beats the tile path at level 2 R and
//     level 3 A and trails it by 10 % at level 2 A.  Tried there and slower:
//     the warps taking the slabs of an entry side by side, one warp a slab
//     over the whole part, and staging colidx alone.
//   * Panel path (kernel 6 only: f64, m of at least onehot.CSR_PANEL_M,
//     PAS's working block of 75 columns).  On the split path each entry
//     gathers its whole record of x: at AMG level 2 A 12.86 M entries of
//     600 bytes, 7.7 GB a call from L2, 1.06 ms on the H100 against a
//     0.052 ms bound of device memory.  The coarse levels are banded (level
//     2 A: 17,588 rows of about 731 entries in runs of adjacent columns,
//     level 3 A 71 % dense), so neighbouring rows share records: in a
//     matrix with split rows, the rows of more than onehot.PANEL_MIN
//     entries, in row order, are cut into panels of 16 rows and the columns
//     into k-groups of 8, and the plan (onehot.csr_panels, once per matrix
//     on the host, from colidx and values) keeps each panel's k-groups that
//     hold an entry as dense 16 x 8 tiles of values, zeros in place of the
//     missing entries (28 % of a tile full at level 2 A, 71 % at level 3
//     A), in the f64 mma's fragment order.  A warp takes a panel and 5
//     n-tiles of 8 columns (2 where the panels are few) and walks the
//     panel's k-groups in column order, one mma.sync m16n8k8 an n-tile:
//     8 records of x serve 16 rows, and the tiles (32 bytes a lane) and
//     records of the next two k-groups are in flight.  A matrix of few
//     columns (the coarsest level) has too few panels for the card: its
//     k-groups are cut into fixed chunks of columns, a warp each, whose sums
//     csr_combine adds in chunk order.  A row's sum is the chain of mmas
//     over its panel's k-groups in column order (chunk by chunk); a k-group
//     where the row has no entry adds exact zeros, so a row's bits depend
//     on its own entries, the columns and m alone, wherever it sits (a
//     shard of rows that takes the panel path gives the rows' bits).  The
//     other rows keep the tile path (a launch of the kernel above with no
//     split blocks).  The wrapper takes the path where the tiles are at
//     least onehot.PANEL_FILL full; at level 2 R (17 %) and at m = 10 it
//     measured slower than the split path (PERF.md).  What holds it at
//     level 2 A (0.44 ms on the H100): most likely its gathers of x, 1.9
//     GB a call at about 58 % of the rate the split path reaches.  Each
//     measured slower there: 8 x 4 tiles on m16n8k4 as y^T = x^T A^T (4
//     records for 8 rows), blocks of 4 panels staging the union of their
//     records in shared memory, tiles packed to their entries and a mask,
//     10 n-tiles a warp (the tiles read once, more registers), and more
//     k-groups in flight.
//   Registers are the two paths' price for sharing a kernel: alone the tile
//   path needs 40 in f64 and 32 in f32, with the split path the kernel took
//   more, and the fewer blocks an SM slowed the short rows.  The
//   launch bounds hold the kernel to the tile path's counts (6 blocks of 256
//   threads, 16 of 128 an SM); the split path keeps kSplitBatch = 4 gathers
//   in flight to fit them (the staged kernel, one slot a warp, fits 8),
//   which measured faster than 8 with more registers,
//   than masking the last batch, and than separate kernels for the two paths
//   (which cannot overlap: the split path's long rows then wait for the
//   tiles).
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads of a block: 128 in f32, 256 in f64 (measured the faster of 128,
// 256 and 512 for each type on the H100)
template <typename T>
constexpr int kThreads = sizeof(T) == 8 ? 256 : 128;
template <typename T>
constexpr int kWarps = kThreads<T> / 32;
constexpr int kBatch = 8;       // gathers a thread issues before it adds them
constexpr int kSplitBatch = 4;  // the same on the split path
// entries of a part of a long row (onehot.CSR_PART), and of its range
// widened to 16-byte boundaries, which a block of the split path stages
// where it walks wide records (see staged_split)
constexpr int kPart = 2048;
constexpr int kPartStage = kPart + 8;

// most entries a block stages: colidx and values fit the 48 KB a block may
// use without opting in to more
template <typename T>
constexpr int kMaxBudget = 48 * 1024 / (int)(sizeof(int) + sizeof(T));

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; the bytes past `src_bytes` are
// written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Entries [e0, e1) of colidx and values to s_col and s_val [0, e1 - e0), for
// every thread of the block to read.  copy16: e0 is a multiple of 4 and both
// arrays start on 16 bytes; entries past nnz are zero-filled or not copied.
template <typename T>
__device__ __forceinline__ void stage(int* s_col, T* s_val,
                                      const int* __restrict__ colidx,
                                      const T* __restrict__ values,
                                      int64_t e0, int64_t e1, int64_t nnz,
                                      int copy16) {
  if (copy16) {
    for (int64_t e = e0 + 4 * threadIdx.x; e < e1; e += 4 * kThreads<T>) {
      const int64_t left = nnz - e;
      const int have = (int)(left < 4 ? left : 4);
      cp_async16(s_col + (e - e0), colidx + e, 4 * have);
      if constexpr (sizeof(T) == 4) {
        cp_async16(s_val + (e - e0), values + e, 4 * have);
      } else {
        cp_async16(s_val + (e - e0), values + e, 8 * (have < 2 ? have : 2));
        if (have > 2)
          cp_async16(s_val + (e - e0) + 2, values + e + 2, 8 * (have - 2));
      }
    }
  } else {
    for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads<T>) {
      cp_async4(s_col + (e - e0), colidx + e);
      if constexpr (sizeof(T) == 4)
        cp_async4(s_val + (e - e0), values + e);
      else
        cp_async8(s_val + (e - e0), values + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// VEC elements of x or of y
template <typename T, int VEC>
struct Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_x(const T* p) {
  Vec<T, VEC> r;
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else if constexpr (sizeof(T) == 4 && VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else if constexpr (sizeof(T) == 8 && VEC == 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_y(T* p, const Vec<T, VEC>& a) {
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else if constexpr (sizeof(T) == 4 && VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a.v[0], a.v[1]);
  } else if constexpr (sizeof(T) == 8 && VEC == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(a.v[0], a.v[1]);
  } else {
    p[0] = a.v[0];
  }
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// acc += the staged entries [q0, q1) times their x records, in order.  xg
// points at the item's first column of x; a record's row stride is xs_i.
template <typename T, int VEC>
__device__ __forceinline__ void gather_row(Vec<T, VEC>& acc, const int* s_col,
                                           const T* s_val, int q0, int q1,
                                           const T* xg, int64_t xs_i) {
  int q = q0;
  for (; q + kBatch <= q1; q += kBatch) {
    Vec<T, VEC> xv[kBatch];
    T v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      v[b] = s_val[q + b];
      xv[b] = load_x<T, VEC>(xg + (int64_t)s_col[q + b] * xs_i);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc.v[e] = fma_t(v[b], xv[b].v[e], acc.v[e]);
  }
  for (; q < q1; ++q) {
    const Vec<T, VEC> xv = load_x<T, VEC>(xg + (int64_t)s_col[q] * xs_i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = fma_t(s_val[q], xv.v[e], acc.v[e]);
  }
}

// The tile path, on row tile `tile` (its first row and its end): staged
// entries, one thread an item.  The plan keeps every tile's staged range
// within the budget.
template <typename T, int VEC>
__device__ __forceinline__ void csr_tile(
    const int* __restrict__ rowptr, const int* __restrict__ colidx,
    const T* __restrict__ values, int64_t nnz, const int* __restrict__ tile,
    int budget, int64_t m, const T* __restrict__ x, int64_t xs_i,
    int64_t xs_j, T* __restrict__ y, int64_t ys_i, int64_t ys_j, int copy16,
    int row_fast, int* smem) {
  int* s_col = smem;
  // the values after the column indices, on 16 bytes (budget is a multiple
  // of 4)
  T* s_val = reinterpret_cast<T*>(smem + budget);
  const int r0 = __ldg(tile), r1 = __ldg(tile + 1);
  const int64_t p0 = __ldg(rowptr + r0), p1 = __ldg(rowptr + r1);
  const int64_t e0 = copy16 ? (p0 & ~(int64_t)3) : p0;
  const int64_t e1 = copy16 ? ((p1 + 3) & ~(int64_t)3) : p1;
  if (e1 - e0 > budget) __trap();   // not a plan of onehot.csr_plan
  stage<T>(s_col, s_val, colidx, values, e0, e1, nnz, copy16);
  const int groups = (int)(m / VEC);
  const int nrows = r1 - r0;
  const int items = nrows * groups;
  for (int it = threadIdx.x; it < items; it += kThreads<T>) {
    int a, g;
    if (row_fast) {
      g = it / nrows;
      a = it - g * nrows;
    } else {
      a = it / groups;
      g = it - a * groups;
    }
    const int64_t r = r0 + a;
    Vec<T, VEC> acc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = T(0);
    gather_row<T, VEC>(acc, s_col, s_val, (int)(__ldg(rowptr + r) - e0),
                       (int)(__ldg(rowptr + r + 1) - e0),
                       x + (int64_t)g * VEC * xs_j, xs_i);
    store_y<T, VEC>(y + r * ys_i + (int64_t)g * VEC * ys_j, acc);
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// LV elements of x at p, xs_j apart, VEC at a time (xs_j is 1 where VEC > 1)
template <typename T, int VEC, int LV>
__device__ __forceinline__ void load_lv(T (&r)[LV], const T* p,
                                        int64_t xs_j) {
#pragma unroll
  for (int i = 0; i < LV; i += VEC) {
    const Vec<T, VEC> t = load_x<T, VEC>(p + i * xs_j);
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[i + e] = t.v[e];
  }
}

// acc += the entries e0, e0 + step, ... below e1 times their x records, in
// that order, kSplitBatch gathers in flight (kStaged: kBatch).  cols and vals: colidx and
// values in device memory, or (kStaged) the part's entries in shared memory,
// e0 and e1 then counted from its first staged entry.  xg points at the
// lane's first column of x.
template <typename T, int VEC, int LV, bool kStaged>
__device__ __forceinline__ void gather_strided(
    T (&acc)[LV], const int* __restrict__ cols, const T* __restrict__ vals,
    int64_t e0, int64_t e1, int step, const T* xg, int64_t xs_i,
    int64_t xs_j) {
  const auto col = [&](int64_t e) {
    return kStaged ? cols[e] : __ldg(cols + e);
  };
  const auto val = [&](int64_t e) {
    return kStaged ? vals[e] : __ldg(vals + e);
  };
  constexpr int kB = kStaged ? kBatch : kSplitBatch;
  int64_t e = e0;
  for (; e + (int64_t)(kB - 1) * step < e1;
       e += (int64_t)kB * step) {
    int c[kB];
    T v[kB];
    T xv[kB][LV];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      c[b] = col(e + b * step);
      v[b] = val(e + b * step);
    }
#pragma unroll
    for (int b = 0; b < kB; ++b)
      load_lv<T, VEC, LV>(xv[b], xg + (int64_t)c[b] * xs_i, xs_j);
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int i = 0; i < LV; ++i) acc[i] = fma_t(v[b], xv[b][i], acc[i]);
  }
  for (; e < e1; e += step) {
    T xv[LV];
    load_lv<T, VEC, LV>(xv, xg + (int64_t)col(e) * xs_i, xs_j);
    const T v = val(e);
#pragma unroll
    for (int i = 0; i < LV; ++i) acc[i] = fma_t(v, xv[i], acc[i]);
  }
}

// Whether the split path stages a part's entries in shared memory first
// (the launch picks the kernel compiled for it: one kernel holding both
// gathers measured slower in both, under its register bound): where a
// warp's first slab holds one entry slot (m / LV > 16 column groups), each
// lane walks a long chain of the warp's entries, and reading their colidx
// from shared memory spares a round trip to device memory a batch (faster
// at m = 75, PAS's width, on the H100); with several slots a warp the
// chains are short, and the staging (a round trip, a barrier, and shared
// memory taken from L1) measured slower at m = 10.  Either way the sums run
// in the same order.
__host__ __device__ constexpr bool staged_split(int64_t groups) {
  return groups > 16;
}

// The split path: part d.y of the d.z parts of row d.x on the whole block.
// d.w < 0: the only part, stored to y; else the part's sums go to row d.w of
// scratch ((slots, m), contiguous) for csr_combine.  s_sum: two buffers of
// kWarps * 32 * LV elements in shared memory, used by turns, so that one
// barrier a slab of column groups suffices.
template <typename T, int VEC, int LV, bool kStaged>
__device__ __forceinline__ void csr_split_part(
    const int* __restrict__ rowptr, const int* __restrict__ colidx,
    const T* __restrict__ values, int64_t nnz, int4 d, int64_t m,
    const T* __restrict__ x, int64_t xs_i, int64_t xs_j, T* __restrict__ y,
    int64_t ys_i, int64_t ys_j, T* __restrict__ scratch, int copy16,
    int* smem) {
  const int64_t p0 = __ldg(rowptr + d.x);
  const int64_t len = __ldg(rowptr + d.x + 1) - p0;
  const int64_t per_part = (len + d.z - 1) / d.z;
  const int64_t a = p0 + d.y * per_part;
  const int64_t b = p0 + min64(len, (d.y + 1) * per_part);
  // where it stages: the entries [e0, e1) in shared memory, then the sums
  const int64_t e0 = copy16 ? (a & ~(int64_t)3) : a;
  const int64_t e1 = copy16 ? ((b + 3) & ~(int64_t)3) : b;
  int* s_col = smem;
  T* s_val = reinterpret_cast<T*>(smem + kPartStage);
  T* s_sum = kStaged ? s_val + kPartStage : reinterpret_cast<T*>(smem);
  if constexpr (kStaged) {
    if (e1 - e0 > kPartStage) __trap();   // not a plan of onehot.csr_plan
    stage<T>(s_col, s_val, colidx, values, e0, e1, nnz, copy16);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t per_warp = (b - a + kWarps<T> - 1) / kWarps<T>;
  const int64_t wa = a + warp * per_warp;
  const int64_t wb = min64(b, wa + per_warp);
  const int groups = (int)(m / LV);
  for (int g0 = 0, slab = 0; g0 < groups; g0 += 32, ++slab) {
    const int G = min(32, groups - g0);
    const int E = 32 / G;
    const int s = lane / G, g = lane - s * G;   // entry slot, column group
    T acc[LV];
#pragma unroll
    for (int i = 0; i < LV; ++i) acc[i] = T(0);
    const T* xg = x + (int64_t)(g0 + g) * LV * xs_j;
    if (s < E) {
      if constexpr (kStaged)
        gather_strided<T, VEC, LV, true>(acc, s_col, s_val, wa + s - e0,
                                         wb - e0, E, xg, xs_i, xs_j);
      else
        gather_strided<T, VEC, LV, false>(acc, colidx, values, wa + s, wb,
                                          E, xg, xs_i, xs_j);
    }
    // slot s += slot s + h, for h = 1, 2, 4, ...: slot 0 ends with the sum
    for (int h = 1; h < E; h *= 2) {
#pragma unroll
      for (int i = 0; i < LV; ++i) {
        const T other = __shfl_down_sync(0xffffffffu, acc[i], h * G);
        if ((s & (2 * h - 1)) == 0 && s + h < E) acc[i] += other;
      }
    }
    T* buf = s_sum + (slab & 1) * (kWarps<T> * 32 * LV);
    if (lane < G) {
#pragma unroll
      for (int i = 0; i < LV; ++i) buf[(warp * 32 + lane) * LV + i] = acc[i];
    }
    __syncthreads();
    if (warp == 0 && lane < G) {
      T sum[LV];
#pragma unroll
      for (int i = 0; i < LV; ++i) sum[i] = buf[lane * LV + i];
      for (int w = 1; w < kWarps<T>; ++w)
#pragma unroll
        for (int i = 0; i < LV; ++i) sum[i] += buf[(w * 32 + lane) * LV + i];
      const int64_t j = (int64_t)(g0 + lane) * LV;
      if (d.w < 0) {
        T* out = y + (int64_t)d.x * ys_i + j * ys_j;
#pragma unroll
        for (int i = 0; i < LV; i += VEC) {
          Vec<T, VEC> t;
#pragma unroll
          for (int e = 0; e < VEC; ++e) t.v[e] = sum[i + e];
          store_y<T, VEC>(out + i * ys_j, t);
        }
      } else {
#pragma unroll
        for (int i = 0; i < LV; ++i) scratch[d.w * m + j + i] = sum[i];
      }
    }
  }
}

template <typename T, int VEC, int LV, bool kStaged>
__device__ __forceinline__ void csr_spmm_body(
    const int* __restrict__ rowptr, const int* __restrict__ colidx,
    const T* __restrict__ values, int64_t nnz, const int* __restrict__ tiles,
    int budget, const int4* __restrict__ split, int nsplit,
    T* __restrict__ scratch, int64_t m, const T* __restrict__ x,
    int64_t xs_i, int64_t xs_j, T* __restrict__ y, int64_t ys_i,
    int64_t ys_j, int copy16, int row_fast, int* smem) {
  if ((int)blockIdx.x < nsplit)
    csr_split_part<T, VEC, LV, kStaged>(rowptr, colidx, values, nnz,
                               split[blockIdx.x], m, x, xs_i, xs_j, y, ys_i,
                               ys_j, scratch, copy16, smem);
  else
    csr_tile<T, VEC>(rowptr, colidx, values, nnz,
                     tiles + 2 * ((int)blockIdx.x - nsplit), budget, m, x,
                     xs_i, xs_j, y, ys_i, ys_j, copy16, row_fast, smem);
}

// the launch bounds hold both kernels to the tile path's registers (see the
// note at the top)
template <int VEC, int LV, bool kStaged>
__global__ void __launch_bounds__(kThreads<float>, 16)
    csr_spmm_f32(const int* __restrict__ rowptr,
                 const int* __restrict__ colidx,
                 const float* __restrict__ values, int64_t nnz,
                 const int* __restrict__ tiles, int budget,
                 const int4* __restrict__ split, int nsplit,
                 float* __restrict__ scratch, int64_t m,
                 const float* __restrict__ x, int64_t xs_i, int64_t xs_j,
                 float* __restrict__ y, int64_t ys_i, int64_t ys_j,
                 int copy16, int row_fast) {
  extern __shared__ __align__(16) int smem_f[];
  csr_spmm_body<float, VEC, LV, kStaged>(
      rowptr, colidx, values, nnz, tiles, budget, split, nsplit, scratch, m,
      x, xs_i, xs_j, y, ys_i, ys_j, copy16, row_fast, smem_f);
}

template <int VEC, int LV, bool kStaged>
__global__ void __launch_bounds__(kThreads<double>, 6)
    csr_spmm_f64(const int* __restrict__ rowptr,
                 const int* __restrict__ colidx,
                 const double* __restrict__ values, int64_t nnz,
                 const int* __restrict__ tiles, int budget,
                 const int4* __restrict__ split, int nsplit,
                 double* __restrict__ scratch, int64_t m,
                 const double* __restrict__ x, int64_t xs_i, int64_t xs_j,
                 double* __restrict__ y, int64_t ys_i, int64_t ys_j,
                 int copy16, int row_fast) {
  extern __shared__ __align__(16) int smem_d[];
  csr_spmm_body<double, VEC, LV, kStaged>(
      rowptr, colidx, values, nnz, tiles, budget, split, nsplit, scratch, m,
      x, xs_i, xs_j, y, ys_i, ys_j, copy16, row_fast, smem_d);
}

// y[row] = the sum of its parts' rows of scratch, in part order; multi:
// (row, first slot, parts, 0) for each row of more than one part
template <typename T>
__global__ void csr_combine(const int4* __restrict__ multi, int64_t nmulti,
                            int64_t m, const T* __restrict__ scratch,
                            T* __restrict__ y, int64_t ys_i, int64_t ys_j) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nmulti * m) return;
  const int64_t k = t / m, j = t - k * m;
  const int4 d = multi[k];
  const T* p = scratch + (int64_t)d.y * m + j;
  T sum = p[0];
  for (int q = 1; q < d.z; ++q) sum += p[(int64_t)q * m];
  y[(int64_t)d.x * ys_i + j * ys_j] = sum;
}

// shared memory of a block: the tile path's staged entries, or the split
// path's two buffers of warp sums, after its staged entries where it stages
template <typename T, int LV>
size_t smem_bytes(int64_t budget, int64_t nsplit, int64_t m) {
  const size_t tile = (size_t)budget * (sizeof(int) + sizeof(T));
  const size_t sums = 2 * kWarps<T> * 32 * LV * sizeof(T);
  const size_t part =
      nsplit == 0               ? 0
      : staged_split(m / LV) ? kPartStage * (sizeof(int) + sizeof(T)) + sums
                               : sums;
  return tile > part ? tile : part;
}

template <typename T, int VEC, int LV, bool kStaged>
int launch_spmm(const int* rowptr, const int* colidx, const T* values,
                int64_t nnz, const int* tiles, int64_t ntiles, int budget,
                const int4* split, int64_t nsplit, T* scratch, int64_t m,
                const T* x, int64_t xs_i, int64_t xs_j, T* y, int64_t ys_i,
                int64_t ys_j, int copy16, int row_fast, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, LV>(budget, nsplit, m);
  const unsigned blocks = (unsigned)(nsplit + ntiles);
  if constexpr (sizeof(T) == 8)
    csr_spmm_f64<VEC, LV, kStaged><<<blocks, kThreads<T>, smem, stream>>>(
        rowptr, colidx, values, nnz, tiles, budget, split, (int)nsplit,
        scratch, m, x, xs_i, xs_j, y, ys_i, ys_j, copy16, row_fast);
  else
    csr_spmm_f32<VEC, LV, kStaged><<<blocks, kThreads<T>, smem, stream>>>(
        rowptr, colidx, values, nnz, tiles, budget, split, (int)nsplit,
        scratch, m, x, xs_i, xs_j, y, ys_i, ys_j, copy16, row_fast);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int LV>
int launch(const int* rowptr, const int* colidx, const T* values, int64_t nnz,
           const int* tiles, int64_t ntiles, int budget, const int4* split,
           int64_t nsplit, int64_t nmulti, T* scratch, int64_t m, const T* x,
           int64_t xs_i, int64_t xs_j, T* y, int64_t ys_i, int64_t ys_j,
           int copy16, int row_fast, cudaStream_t stream) {
  if (nsplit + ntiles > 0) {
    const auto fn = staged_split(m / LV) ? launch_spmm<T, VEC, LV, true>
                                         : launch_spmm<T, VEC, LV, false>;
    const int err = fn(rowptr, colidx, values, nnz, tiles, ntiles, budget,
                       split, nsplit, scratch, m, x, xs_i, xs_j, y, ys_i,
                       ys_j, copy16, row_fast, stream);
    if (err != 0) return err;
  }
  if (nmulti > 0) {
    const int64_t items = nmulti * m;
    csr_combine<T><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
        split + nsplit, nmulti, m, scratch, y, ys_i, ys_j);
  }
  return (int)cudaGetLastError();
}

// d += A B for one 16 x 8 x 8 tile on the f64 tensor cores (the layout of
// tall_gemm.cu's dmma, which osgemm.dmma_tile_check checks on the card).
// With g = lane/4 and t = lane%4: a = (A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]), b = (B[t][g], B[t+4][g]), d = (D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// The panel path (see the note at the top).  Warp w of block b takes panel
// p = b * warps + w (rows rows[16 p + i], i < 16), the NT n-tiles of 8
// columns from column 8 NT blockIdx.y and column chunk c = blockIdx.z, and
// walks the chunk's k-groups of the panel, [ptr[p chunks + c], ptr[p
// chunks + c + 1]), in column order: per k-group the lane's 4 values of the
// 16 x 8 tile (vals[q], in fragment order, 32 bytes a lane) and for each
// n-tile its 2 elements of x (rows kcol[q] + t and + 4), then NT mmas;
// the fragments of the next D k-groups are in flight while a k-group's
// mmas run.  One chunk: the sums go to y; else to row k chunks + c of
// scratch ((nrows chunks, m)), for csr_combine to add in chunk order.
template <int NT, int D>
__global__ void __launch_bounds__(128)
    csr_panel_f64(const int* __restrict__ rows, int64_t nrows,
                  const int* __restrict__ ptr, int64_t npanels,
                  int64_t chunks, const int* __restrict__ kcol,
                  const double* __restrict__ vals, int64_t n_cols,
                  int64_t m, const double* __restrict__ x, int64_t xs_i,
                  int64_t xs_j, double* __restrict__ y, int64_t ys_i,
                  int64_t ys_j, double* __restrict__ scratch) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t p =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= npanels) return;
  const int64_t pc = p * chunks + blockIdx.z;
  const int64_t c0 = (int64_t)blockIdx.y * NT * 8 + g;   // the lane's column
  double acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
  const int64_t q0 = __ldg(ptr + pc), q1 = __ldg(ptr + pc + 1);
  double a[D][4], b[D][NT][2];
  const auto load = [&](int64_t q, int s) {
    if (q >= q1) return;
    const double2* tp =
        reinterpret_cast<const double2*>(vals + q * 128 + lane * 4);
    const double2 lo = __ldg(tp), hi = __ldg(tp + 1);
    a[s][0] = lo.x, a[s][1] = lo.y, a[s][2] = hi.x, a[s][3] = hi.y;
    const int64_t k0 = __ldg(kcol + q) + t;
    const bool in0 = k0 < n_cols, in1 = k0 + 4 < n_cols;
    const double* x0 = x + k0 * xs_i;
    const double* x1 = x0 + 4 * xs_i;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int64_t c = c0 + 8 * j;
      b[s][j][0] = in0 && c < m ? __ldg(x0 + c * xs_j) : 0.0;
      b[s][j][1] = in1 && c < m ? __ldg(x1 + c * xs_j) : 0.0;
    }
  };
#pragma unroll
  for (int s = 0; s < D; ++s) load(q0 + s, s);
  for (int64_t q = q0; q < q1; q += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      if (q + s < q1) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          dmma(acc[j], a[s], b[s][j][0], b[s][j][1]);
        load(q + s + D, s);
      }
    }
  }
  // d = (y[g][c], y[g][c + 1], y[g + 8][c], y[g + 8][c + 1]), c = 2t in
  // each n-tile, rows g and g + 8 of the panel
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t k = p * 16 + g + 8 * h;
    if (k >= nrows) continue;
    const bool whole = chunks == 1;
    double* out = whole ? y + (int64_t)__ldg(rows + k) * ys_i
                        : scratch + (k * chunks + blockIdx.z) * m;
    const int64_t cs = whole ? ys_j : 1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int64_t c = c0 - g + 8 * j + 2 * t;
      if (c < m) out[c * cs] = acc[j][2 * h];
      if (c + 1 < m) out[(c + 1) * cs] = acc[j][2 * h + 1];
    }
  }
}

// columns a lane of the split path gathers: a function of m and T alone
template <typename T>
int64_t lane_width(int64_t m) {
  if (sizeof(T) == 4 && m % 4 == 0) return 4;
  return m % 2 == 0 ? 2 : 1;
}

// a plan the kernels cannot take: a budget that is not a positive multiple
// of 4 up to kMaxBudget, vec not one of T's widths or not dividing m, a
// negative count, scratch missing for rows of several parts, a grid past
// the int range
template <typename T>
bool bad_plan(int64_t ntiles, int64_t budget, int64_t nsplit, int64_t nmulti,
              const void* scratch, int64_t m, int64_t vec) {
  const bool vec_ok = vec == 1 || vec == 2 || (sizeof(T) == 4 && vec == 4);
  return budget <= 0 || budget % 4 != 0 || budget > kMaxBudget<T> ||
         !vec_ok || m % vec != 0 || ntiles < 0 || nsplit < 0 || nmulti < 0 ||
         (nmulti > 0 && scratch == nullptr) ||
         ntiles + nsplit > (int64_t)0x7fffffff;
}

}  // namespace

// The panel path of kernel 6 (see the note at the top; onehot.csr_panels
// makes the plan): rows (nrows,) the panels' rows in order; ptr (npanels
// chunks + 1,) each panel's k-groups by column chunk; kcol (nkg,) a
// k-group's first column; vals (nkg, 128) its 16 x 8 values in fragment
// order, 16-byte aligned; multi (nrows, 4): (row, k chunks, chunks, 0) for
// csr_combine where chunks > 1, with scratch (nrows chunks, m); warps:
// panels a block (1 to 4); nt: n-tiles of 8 columns a warp (2 or 5).
// Writes the rows `rows` of y.
extern "C" int gcge_csr_panel_f64(const void* rows, int64_t nrows,
                                  const void* ptr, int64_t npanels,
                                  int64_t chunks, const void* kcol,
                                  const void* vals, const void* multi,
                                  void* scratch, int64_t n_cols, int64_t m,
                                  const void* x, int64_t xs_i, int64_t xs_j,
                                  void* y, int64_t ys_i, int64_t ys_j,
                                  int64_t warps, int64_t nt, void* stream) {
  const int64_t groups = (m + 8 * nt - 1) / (8 * nt);
  if (warps < 1 || warps > 4 || (nt != 2 && nt != 5) || m < 1 ||
      chunks < 1 || chunks > 0xffff || nrows > 16 * npanels ||
      (chunks > 1 && (multi == nullptr || scratch == nullptr)) ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0 ||
      (npanels + warps - 1) / warps > (int64_t)0x7fffffff || groups > 0xffff)
    return (int)cudaErrorInvalidValue;
  if (npanels == 0) return 0;
  const dim3 grid((unsigned)((npanels + warps - 1) / warps),
                  (unsigned)groups, (unsigned)chunks);
  // two k-groups in flight
  const auto fn = nt == 5 ? csr_panel_f64<5, 2> : csr_panel_f64<2, 2>;
  fn<<<grid, (unsigned)(32 * warps), 0, (cudaStream_t)stream>>>(
      (const int*)rows, nrows, (const int*)ptr, npanels, chunks,
      (const int*)kcol, (const double*)vals, n_cols, m, (const double*)x,
      xs_i, xs_j, (double*)y, ys_i, ys_j, (double*)scratch);
  int err = (int)cudaGetLastError();
  if (err != 0 || chunks == 1) return err;
  const int64_t items = nrows * m;
  csr_combine<double><<<(unsigned)((items + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
      (const int4*)multi, nrows, m, (const double*)scratch, (double*)y, ys_i,
      ys_j);
  return (int)cudaGetLastError();
}

// Kernels 5 (f32) and 6 (f64).  tiles: ntiles (first row, end) pairs of row
// tiles (onehot.csr_plan); budget: entries of colidx and values a tile
// stages, a multiple of 4 up to kMaxBudget; split: nsplit (row, part, parts,
// scratch slot or -1) blocks of the split path, then nmulti (row, first
// slot, parts, 0) rows of several parts; scratch: (slots, m) of T for those
// rows' partial sums (may be null where nmulti is 0); vec: elements a thread
// gathers and stores at once (f32: 4, 2 or 1; f64: 2 or 1; dividing m);
// copy16: colidx and values start on 16 bytes; row_fast: the tile path's
// rows run fastest (y's rows adjacent).  The launch plan is
// onehot.csr_plan's and the wrapper's.
extern "C" int gcge_csr_spmm_f32(
    const void* rowptr, const void* colidx, const void* values, int64_t nnz,
    const void* tiles, int64_t ntiles, int64_t budget, const void* split,
    int64_t nsplit, int64_t nmulti, void* scratch, int64_t m, const void* x,
    int64_t xs_i, int64_t xs_j, void* y, int64_t ys_i, int64_t ys_j,
    int64_t vec, int64_t copy16, int64_t row_fast, void* stream) {
  if (bad_plan<float>(ntiles, budget, nsplit, nmulti, scratch, m, vec))
    return (int)cudaErrorInvalidValue;
  const int64_t lv = lane_width<float>(m);
  const auto fn = vec == 4   ? launch<float, 4, 4>
                  : vec == 2 ? (lv == 4 ? launch<float, 2, 4>
                                        : launch<float, 2, 2>)
                  : lv == 4  ? launch<float, 1, 4>
                  : lv == 2  ? launch<float, 1, 2>
                             : launch<float, 1, 1>;
  return fn((const int*)rowptr, (const int*)colidx, (const float*)values,
            nnz, (const int*)tiles, ntiles, (int)budget, (const int4*)split,
            nsplit, nmulti, (float*)scratch, m, (const float*)x, xs_i, xs_j,
            (float*)y, ys_i, ys_j, (int)copy16, (int)row_fast,
            (cudaStream_t)stream);
}

extern "C" int gcge_csr_spmm_f64(
    const void* rowptr, const void* colidx, const void* values, int64_t nnz,
    const void* tiles, int64_t ntiles, int64_t budget, const void* split,
    int64_t nsplit, int64_t nmulti, void* scratch, int64_t m, const void* x,
    int64_t xs_i, int64_t xs_j, void* y, int64_t ys_i, int64_t ys_j,
    int64_t vec, int64_t copy16, int64_t row_fast, void* stream) {
  if (bad_plan<double>(ntiles, budget, nsplit, nmulti, scratch, m, vec))
    return (int)cudaErrorInvalidValue;
  const auto fn = vec == 2                     ? launch<double, 2, 2>
                  : lane_width<double>(m) == 2 ? launch<double, 1, 2>
                                               : launch<double, 1, 1>;
  return fn((const int*)rowptr, (const int*)colidx, (const double*)values,
            nnz, (const int*)tiles, ntiles, (int)budget, (const int4*)split,
            nsplit, nmulti, (double*)scratch, m, (const double*)x, xs_i,
            xs_j, (double*)y, ys_i, ys_j, (int)copy16, (int)row_fast,
            (cudaStream_t)stream);
}
