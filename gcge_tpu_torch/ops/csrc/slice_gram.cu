// Sliced-Gram isolation kernel on Hopper (kernel 9 of the port).
//
// Replaces the kernel of benchmarks/pallas_isolate.py:make(mode): the pieces
// of the TPU's f64-accurate tall Gram (kernel 3 there), run one at a time to
// say what each costs.  Operands are the hi/lo f32 planes of A (P rows) and
// B (Q rows), n_pad columns each, row-major.  Per chunk of NR columns:
//
//   peel  each (hi, lo) value into 7 bf16 slices of 7 bits (unit 2^-7(k+1):
//         s_k = rint(r 2^7(k+1)) 2^-7(k+1), r -= s_k; hi alone feeds slices
//         0..2, then lo joins through a two-sum whose error term is added
//         back after slice 4), stacked as rows k P + p (k Q + q);
//   dot   the (7P x NR)(NR x 7Q) product of the stacks, added to a
//         (7P x 7Q) f32 slab that runs over all chunks.
//
// mode bit 0 = peel, bit 1 = dot: 0 `none` (loads and a cast: slice 0 is
// bf16(hi), the other slices are zero), 1 `peel`, 2 `dot`, 3 `full`.  Without
// the dot the output is zeros, as the TPU kernel's is.
//
// What bounds it: all modes read the four planes once, 8 (P + Q) n_pad bytes
// (181.7 MB at P = 128, Q = 16, n_pad = 157,696: 0.054 ms at 3.35 TB/s).  The
// dot adds 2 * 49 P Q n_pad = 3.17e10 operations, 0.032 ms on the bf16
// tensor cores (0.47 ms as f32 FMAs on the CUDA cores), and the peel about
// 6e8 f32 operations, 0.009 ms: every mode is bound by its bytes.
//
// Design.  The TPU walks the chunks in order on one core and carries the slab
// in scratch memory.  Here a block owns 16 rows of A against all (at most 16)
// rows of B and a run of consecutive chunks; the grid is (runs, P / 16), one
// block an SM.  The block walks its run in steps of 64 columns, and its warps
// are specialised:
//
//   producers (warps 8-15, 256 threads): thread (row, c4) fetches its float4
//     of each of the four planes a step (row `row` of A's and of B's 16 x 64
//     tile, columns 4 c4 ..) into its own places of a raw ring in shared
//     memory by 16-byte cp.async, kRawRing steps ahead, so that 64 KB an SM
//     are in flight and no register holds them; it reads them back, peels
//     them in registers and writes the bf16 slices straight into a ring of
//     stacks: per slot A's stack (7 slices x 16 rows, and an 8th slice of
//     zeros) and B's (7 x 16; rows past Q are zeros), rows of 64 bf16 = 128
//     bytes whose 16-byte pieces are swizzled by (row % 8), the 128-byte
//     swizzle wgmma reads.  The peel takes a path of full-rate f32 adds
//     where the warp's values allow it (peel7_fast), else rintf (peel7).
//   consumers (warps 0-7, two warpgroups): warpgroup w multiplies A's slices
//     4w .. 4w + 3 (64 rows) by all of B's stack (112 rows) with four bf16
//     wgmma m64n112k16 a step, f32 accumulators (56 a thread): warp w of the
//     block holds the rows of A's slice w.
//
// mbarriers hand the slots over: a producer arrives on a slot's `full`
// barrier once its stores are fenced for the async proxy, a consumer warp
// arrives on its `empty` barrier once its wgmma are done.  Why wgmma: with
// mma.sync fed by ldmatrix every warp reads all of B's fragments each
// k-step, and shared-memory reads bound the product; wgmma reads each
// operand once a warpgroup.
//
// Order of the sums.  A chunk's products are summed by the tensor cores in
// their own order; with 7-bit slices every product and partial sum lies on
// the grid of its slice pair and (at the shapes the tests use) below 2^24
// units, so the chunk sum is exact whatever the order, and the tensor cores'
// truncating alignment loses nothing.  At a chunk's end the block adds its
// chunk sum into the run's sum in chunk order, S = ((C_g0 + C_g0+1) + ...),
// kept per thread in shared memory (f32, round to nearest); at the run's end
// it writes S to scratch (runs, 7P, 7Q), and a second kernel adds the run sums
// in run order into one f32 slab, starting from 0.  With runs of one chunk
// this is the TPU kernel's order of additions, ((0 + C_0) + C_1) + ..., and
// the plain version's bits; with longer runs the association across chunks
// differs, and the bits are those of the plain version summed in the same
// runs.  No atomics: the result is the same from launch to launch.
//
// Keeping the work alive.  Without the dot nothing computed is stored, and
// nvcc deletes work whose result is never used.  The kernel ends with a store
// of one shared-memory element of the stacks per thread (and of a checksum of
// the lo plane in the modes that do not peel it) under `keep_alive`, a
// run-time argument that the wrapper always passes as 0: the compiler must
// keep every load, peel and shared-memory store, and the store itself never
// runs.
//
// Plain C interface: returns the first error of its launches.  Also here:
// gcge_bf16_mma_tile_check, one (64 x 64)(64 x 112) product through the same
// stack layout, descriptors and wgmma as the kernel, which checks the
// operand and accumulator layouts on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaWarps = 8;   // warps 0-7 multiply: two warpgroups
constexpr int kProducers = 256;  // threads of warps 8-15: load and peel
constexpr int kThreads = 32 * kMmaWarps + kProducers;
constexpr int kSlices = 7;
constexpr int kRows = 16;      // rows of A per block; rows of B (Q <= 16)
constexpr int kKC = 64;        // columns per step: one 128-byte row of bf16
constexpr int kRing = 2;       // slots of the ring of stacks
constexpr int kRawRing = 4;    // slots of the ring of hi/lo planes (steps)
constexpr int kRawSlot = 4 * kRows * kKC;  // floats: A hi, A lo, B hi, B lo
constexpr int kStackA = 8 * kRows * kKC;  // A's stack, 8th slice zeros
constexpr int kSlot = kStackA + kSlices * kRows * kKC;  // bf16 of a slot
constexpr int kRawBytes = kRawRing * kRawSlot * 4;      // 65,536
constexpr int kRingBytes = kRing * kSlot * 2;           // 61,440
constexpr int kBarBytes = 2 * kRing * 8;
constexpr int kRunBytes = 56 * 32 * kMmaWarps * 4;      // 57,344
constexpr int kSmemMax =
    1024 + kRawBytes + kRingBytes + kBarBytes + kRunBytes;

// 2^(7 (k + 1)) and its inverse, exact in f32 for k < 7
__device__ __forceinline__ float unit_inv(int k) {
  return __int_as_float((127 + 7 * (k + 1)) << 23);
}
__device__ __forceinline__ float unit(int k) {
  return __int_as_float((127 - 7 * (k + 1)) << 23);
}

// The peel of benchmarks/pallas_isolate.py:peel_stack for one value; every
// operation rounds on its own (no contraction), rint rounds half to even.
__device__ __forceinline__ void peel7(float hi, float lo, float s[kSlices]) {
  float r = hi;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[k] = __fmul_rn(rintf(__fmul_rn(r, unit_inv(k))), unit(k));
    r = __fsub_rn(r, s[k]);
  }
  const float sum = __fadd_rn(r, lo);  // two-sum of the remainder and lo
  const float bb = __fsub_rn(sum, r);
  const float rl = __fadd_rn(__fsub_rn(r, __fsub_rn(sum, bb)),
                             __fsub_rn(lo, bb));
  r = sum;
#pragma unroll
  for (int k = 3; k < kSlices; ++k) {
    s[k] = __fmul_rn(rintf(__fmul_rn(r, unit_inv(k))), unit(k));
    r = __fsub_rn(r, s[k]);
    if (k == 4) r = __fadd_rn(r, rl);
  }
}

// The same peel for a value with |hi| < 2^15 and |lo| < 2^-21, in full-rate
// f32 adds only.  (r + C) - C with C = 1.5 * 2^(23 - 7(k+1)) rounds r half
// to even onto the grid of slice k while |r| < 2^(22 - 7(k+1)).  Under those
// bounds every r is inside its slice's range (|hi| < 2^15 for slice 0; the
// remainders of slices 0-2 are below 2^-8, 2^-15, 2^-22; |r + lo| < 2^-20
// for slice 3), and slices 1-6 are integers of at most 256 times their
// unit: exact in bf16.  The values are peel7's; where a slice is zero and
// its remainder negative, peel7 gives -0 and this +0, which no product or
// sum of the slab can show (the accumulators start at +0).
__device__ __forceinline__ float round_to_slice(float r, int k) {
  const float c = __int_as_float((127 + 23 - 7 * (k + 1)) << 23) * 1.5f;
  return __fsub_rn(__fadd_rn(r, c), c);
}

__device__ __forceinline__ void peel7_fast(float hi, float lo,
                                           float s[kSlices]) {
  float r = hi;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[k] = round_to_slice(r, k);
    r = __fsub_rn(r, s[k]);
  }
  const float sum = __fadd_rn(r, lo);
  const float bb = __fsub_rn(sum, r);
  const float rl = __fadd_rn(__fsub_rn(r, __fsub_rn(sum, bb)),
                             __fsub_rn(lo, bb));
  r = sum;
#pragma unroll
  for (int k = 3; k < kSlices; ++k) {
    s[k] = round_to_slice(r, k);
    r = __fsub_rn(r, s[k]);
    if (k == 4) r = __fadd_rn(r, rl);
  }
}

__device__ __forceinline__ bool fast_peel_fits(float4 h, float4 l) {
  constexpr float kHi = 32768.f, kLo = 0x1p-21f;  // comparisons false for NaN
  return (fabsf(h.x) < kHi) & (fabsf(h.y) < kHi) & (fabsf(h.z) < kHi) &
         (fabsf(h.w) < kHi) & (fabsf(l.x) < kLo) & (fabsf(l.y) < kLo) &
         (fabsf(l.z) < kLo) & (fabsf(l.w) < kLo);
}

// Element offset of (row, col) in one 16 x 64 slice of a stack: 16-byte
// pieces of a row swizzled by row % 8.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kKC + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary of shared memory at or after p
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a low, b high
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += A B^T for one k16 step of a 64 x 112 tile on the bf16 tensor cores
// (wgmma, the four warps of a warpgroup together), f32 sums; A's 64 rows and
// B's 112 rows given by shared-memory descriptors.  Thread t of the group
// holds, for n8 tile j, d[4j .. 4j+3] = D[r][8j+2u], D[r][8j+2u+1],
// D[r+8][8j+2u], D[r+8][8j+2u+1] with r = 16 (t / 32) + (t % 32) / 4 and
// u = t % 4.
__device__ __forceinline__ void wgmma_m64n112k16(float d[56], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(da), "l"(db), "r"(1));
}

// A shared-memory matrix descriptor for wgmma: rows of 64 bf16 (128 bytes),
// K-major, 16-byte pieces swizzled by (row % 8) in groups of 8 rows that
// start on 1024 bytes (the 128-byte swizzle); groups 1024 bytes apart.
// Stepping K by 16 inside the row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Makes this thread's shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  A wait that
// never ends (a fault of the kernel) traps instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// Copies 16 bytes from device to shared memory asynchronously (zeros where
// `ok` is false), in this thread's current group of copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Peel (or cast) one float4 pair into a stack: 4 bf16 of each slice at
// (row, c0 .. c0 + 3), one 8-byte store a slice.
template <bool PEEL>
__device__ __forceinline__ void stage(float4 h, float4 l,
                                      __nv_bfloat16* stack, int row, int c0,
                                      unsigned& sink) {
  uint2* dst = reinterpret_cast<uint2*>(stack + swz(row, c0));
  constexpr int kSlice2 = kRows * kKC / 4;  // one slice, in uint2
  if (PEEL) {
    float s0[kSlices], s1[kSlices], s2[kSlices], s3[kSlices];
    if (__all_sync(0xffffffffu, fast_peel_fits(h, l))) {  // warp-uniform
      peel7_fast(h.x, l.x, s0);
      peel7_fast(h.y, l.y, s1);
      peel7_fast(h.z, l.z, s2);
      peel7_fast(h.w, l.w, s3);
      dst[0] = make_uint2(pack2(s0[0], s1[0]), pack2(s2[0], s3[0]));
#pragma unroll
      for (int k = 1; k < kSlices; ++k)  // exact in bf16: the high halves
        dst[k * kSlice2] = make_uint2(
            __byte_perm(__float_as_uint(s0[k]), __float_as_uint(s1[k]),
                        0x7632),
            __byte_perm(__float_as_uint(s2[k]), __float_as_uint(s3[k]),
                        0x7632));
    } else {
      peel7(h.x, l.x, s0);
      peel7(h.y, l.y, s1);
      peel7(h.z, l.z, s2);
      peel7(h.w, l.w, s3);
#pragma unroll
      for (int k = 0; k < kSlices; ++k)
        dst[k * kSlice2] = make_uint2(pack2(s0[k], s1[k]),
                                      pack2(s2[k], s3[k]));
    }
  } else {
    dst[0] = make_uint2(pack2(h.x, h.y), pack2(h.z, h.w));
    // lo is loaded, as the TPU's block is
    sink ^= __float_as_uint(l.x) ^ __float_as_uint(l.y) ^
            __float_as_uint(l.z) ^ __float_as_uint(l.w);
  }
}

// A producer thread (row, c4): its float4 of each of the four planes a step
// (row `row` of A's and of B's 16 x 64 tile, columns 4 c4 ..) comes into
// its own places in the raw ring by 16-byte asynchronous copies, kRawRing
// steps ahead (zeros for rows of B past Q); it reads them back, peels (or
// casts) them into the ring of stacks, makes the stores visible to wgmma,
// signals the slot full, and copies the step kRawRing ahead into the same
// places.  Only the thread itself reads what it copied: no barrier.
template <bool PEEL>
__device__ __forceinline__ void produce(
    int64_t steps, const float* ahi, const float* alo, const float* bhi,
    const float* blo, int64_t p0, int64_t Q, int64_t n_pad, int64_t col0,
    float* raw, __nv_bfloat16* ring, uint64_t* full, uint64_t* empty,
    unsigned& sink) {
  const int pt = threadIdx.x - 32 * kMmaWarps;
  const int row = pt >> 4, c0 = (pt & 15) << 2;
  const bool b_ok = row < Q;
  const int64_t a_off = (p0 + row) * n_pad + col0 + c0;
  const int64_t b_off = (b_ok ? row : 0) * n_pad + col0 + c0;
  float* mine = raw + row * kKC + c0;  // + slot and plane
  auto copy = [&](int64_t s) {
    float* dst = mine + (int)(s % kRawRing) * kRawSlot;
    const int64_t col = s * kKC;
    cp_async16(dst, ahi + a_off + col, true);
    cp_async16(dst + kRows * kKC, alo + a_off + col, true);
    cp_async16(dst + 2 * kRows * kKC, bhi + b_off + col, b_ok);
    cp_async16(dst + 3 * kRows * kKC, blo + b_off + col, b_ok);
  };
  for (int64_t s = 0; s < kRawRing; ++s) {  // a group each, empty past the end
    if (s < steps) copy(s);
    cp_async_commit();
  }
  for (int64_t s = 0; s < steps; ++s) {
    cp_async_wait<kRawRing - 1>();  // step s's group has landed
    const float* src = mine + (int)(s % kRawRing) * kRawSlot;
    const float4 ah = *reinterpret_cast<const float4*>(src);
    const float4 al = *reinterpret_cast<const float4*>(src + kRows * kKC);
    const float4 bh = *reinterpret_cast<const float4*>(src + 2 * kRows * kKC);
    const float4 bl = *reinterpret_cast<const float4*>(src + 3 * kRows * kKC);
    const int slot = (int)(s % kRing);
    if (s >= kRing) bar_wait(&empty[slot], (int)((s / kRing - 1) & 1));
    __nv_bfloat16* sa = ring + slot * kSlot;
    stage<PEEL>(ah, al, sa, row, c0, sink);
    stage<PEEL>(bh, bl, sa + kStackA, row, c0, sink);
    fence_async_shared();
    bar_arrive(&full[slot]);
    if (s + kRawRing < steps) copy(s + kRawRing);
    cp_async_commit();
  }
}

// A consumer warpgroup: slices 4 wg .. 4 wg + 3 of A's 16 rows (the 8th
// slice is zeros) against all 7 slices of B's, a 64 x 112 tile in f32
// accumulators, over the block's steps; at each chunk's end the chunk sums
// go into the run sums, and at the run's end to scratch.
template <bool DOT>
__device__ __forceinline__ void consume(int64_t P, int64_t Q, int64_t p0,
                                        int64_t g0, int64_t g1, int64_t steps,
                                        int64_t steps_per_chunk,
                                        const __nv_bfloat16* ring,
                                        uint64_t* full, uint64_t* empty,
                                        float* run_sum, float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int ka = warp;  // the slice of A this warp's rows of the tile hold
  float acc[56];
#pragma unroll
  for (int i = 0; i < 56; ++i) acc[i] = 0.f;
  for (int64_t s = 0; s < steps; ++s) {
    const int slot = (int)(s % kRing);
    bar_wait(&full[slot], (int)((s / kRing) & 1));
    if (DOT) {
      const unsigned sa = smem_u32(ring + slot * kSlot) + wg * 64 * kKC * 2;
      const unsigned sb = smem_u32(ring + slot * kSlot + kStackA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
        wgmma_m64n112k16(acc, smem_desc(sa + 32 * kk),
                         smem_desc(sb + 32 * kk));
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
    if (DOT && (s + 1) % steps_per_chunk == 0) {  // a chunk's sum is done
      const int64_t g = g0 + s / steps_per_chunk;
      float* mine = run_sum + tid;  // thread-private, no barrier needed
      const int gr = lane >> 2, t = lane & 3;
      float* slab = part + (int64_t)blockIdx.x * (kSlices * P) * (kSlices * Q);
#pragma unroll
      for (int i = 0; i < 56; ++i) {
        float v = acc[i];
        if (g != g0) v = __fadd_rn(mine[i * 32 * kMmaWarps], v);
        if (g + 1 == g1) {
          const int n = 8 * (i >> 2) + 2 * t + (i & 1);
          const int kb = n >> 4, q = n & 15;
          const int64_t prow = ka * P + p0 + gr + ((i >> 1) & 1) * 8;
          if (ka < kSlices && q < Q)
            slab[prow * (kSlices * Q) + kb * Q + q] = v;
        } else {
          mine[i * 32 * kMmaWarps] = v;
        }
        acc[i] = 0.f;
      }
    }
  }
}

template <bool PEEL, bool DOT>
__global__ void __launch_bounds__(kThreads, 1)
    slice_gram_run(const float* __restrict__ ahi, const float* __restrict__ alo,
                   const float* __restrict__ bhi, const float* __restrict__ blo,
                   int64_t P, int64_t Q, int64_t n_pad, int64_t nr,
                   int64_t chunks, int64_t run, int keep_alive,
                   float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // from the first 1024-byte boundary: the raw ring, [slot] (A hi, A lo,
  // B hi, B lo: 16 x 64 f32 each); the ring of stacks, [slot] (A's stack:
  // 8 x 16 x 64 bf16, then B's: 7 x 16 x 64); the barriers; then, where
  // runs hold more than one chunk, the run sums: 56 floats for each of the
  // 256 threads that multiply
  unsigned char* smem = align1024(smem_raw);
  float* raw = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + kRawBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRawBytes + kRingBytes);
  uint64_t* empty = full + kRing;
  float* run_sum = reinterpret_cast<float*>(smem + kRawBytes + kRingBytes +
                                            kBarBytes);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t g0 = (int64_t)blockIdx.x * run;
  const int64_t g1 = g0 + run < chunks ? g0 + run : chunks;
  const int64_t p0 = (int64_t)blockIdx.y * kRows;
  const int64_t steps_per_chunk = nr / kKC;
  const int64_t steps = (g1 - g0) * steps_per_chunk;
  unsigned sink = 0;
  if (tid == 0) {
    for (int slot = 0; slot < kRing; ++slot) {
      bar_init(&full[slot], kProducers);
      bar_init(&empty[slot], kMmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zeros that no producer overwrites: A's 8th slice, and without the peel
  // slices 1..6 of both stacks
  for (int slot = 0; slot < kRing; ++slot) {
    __nv_bfloat16* sa = ring + slot * kSlot;
    uint4* z = reinterpret_cast<uint4*>(sa + kSlices * kRows * kKC);
    for (int e = tid; e < kRows * kKC / 8; e += kThreads)
      z[e] = make_uint4(0u, 0u, 0u, 0u);
    if (!PEEL) {
      for (int op = 0; op < 2; ++op) {
        uint4* zs = reinterpret_cast<uint4*>(sa + op * kStackA + kRows * kKC);
        for (int e = tid; e < (kSlices - 1) * kRows * kKC / 8; e += kThreads)
          zs[e] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  fence_async_shared();
  __syncthreads();

  if (warp >= kMmaWarps) {  // producers: copy, peel, fill the ring
    produce<PEEL>(steps, ahi, alo, bhi, blo, p0, Q, n_pad, g0 * nr, raw,
                  ring, full, empty, sink);
  } else {  // consumers: multiply the stacks as they come
    consume<DOT>(P, Q, p0, g0, g1, steps, steps_per_chunk, ring, full, empty,
                 run_sum, part);
  }
  if (keep_alive != 0) {  // never true: see "Keeping the work alive"
    part[((int64_t)blockIdx.x * gridDim.y + blockIdx.y) * kThreads + tid] =
        __bfloat162float(ring[(tid * 449) % (kRing * kSlot)]) +
        __uint_as_float(sink);
  }
}

// out[t] = ((0 + part[0][t]) + part[1][t]) + ...: the run sums in run order.
__global__ void slice_gram_reduce(const float* __restrict__ part, int64_t runs,
                                  int64_t size, float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= size) return;
  float s = 0.f;
  for (int64_t k = 0; k < runs; ++k) s = __fadd_rn(s, part[k * size + t]);
  out[t] = s;
}

// One 64 x 112 x 64 product, a (64, 64) and b (112, 64) bf16 row-major,
// through the kernel's stack layout, descriptors and wgmma (four k16 steps):
// d = a b^T, (64, 112) f32 row-major.  One warpgroup.
__global__ void __launch_bounds__(128, 1)
    bf16_mma_tile_check(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        float* __restrict__ d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + 64 * kKC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < 64 * kKC; e += 128)  // rows of 16 are slices
    sa[(e / (kRows * kKC)) * kRows * kKC + swz((e / kKC) % kRows, e % kKC)] =
        a[e];
  for (int e = tid; e < 112 * kKC; e += 128)
    sb[(e / (kRows * kKC)) * kRows * kKC + swz((e / kKC) % kRows, e % kKC)] =
        b[e];
  fence_async_shared();
  __syncthreads();
  float acc[56];
#pragma unroll
  for (int i = 0; i < 56; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKC / 16; ++kk)
    wgmma_m64n112k16(acc, smem_desc(smem_u32(sa) + 32 * kk),
                     smem_desc(smem_u32(sb) + 32 * kk));
  wgmma_commit();
  wgmma_wait_all();
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 56; ++i)
    d[(16 * warp + gr + ((i >> 1) & 1) * 8) * 112 + 8 * (i >> 2) + 2 * t +
      (i & 1)] = acc[i];
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, set once per kernel and device
constexpr int kMaxDevices = 64;

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <bool PEEL, bool DOT>
int launch(const float* a0, const float* a1, const float* b0, const float* b1,
           int64_t P, int64_t Q, int64_t n_pad, int64_t nr, int64_t run,
           int keep, float* part, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  auto kernel = slice_gram_run<PEEL, DOT>;
  int err = allow_smem(kernel, kSmemMax, done);
  if (err != 0) return err;
  const int64_t chunks = n_pad / nr;
  const dim3 grid((unsigned)((chunks + run - 1) / run), (unsigned)(P / kRows));
  const int smem = 1024 + kRawBytes + kRingBytes + kBarBytes +
                   (DOT && run > 1 ? kRunBytes : 0);
  kernel<<<grid, kThreads, smem, s>>>(a0, a1, b0, b1, P, Q, n_pad, nr, chunks,
                                      run, keep, part);
  return (int)cudaGetLastError();
}

}  // namespace

// P a multiple of 16, 1 <= Q <= 16, nr a multiple of 64, n_pad a multiple of
// nr, run >= 1 chunks a block, planes contiguous and 16-byte aligned (the
// wrapper checks); part holds ceil((n_pad / nr) / run) * 7P * 7Q floats
// (which is at least kThreads per block, for the keep_alive store), out
// 7P * 7Q.
extern "C" int gcge_slice_gram(const void* ahi, const void* alo,
                               const void* bhi, const void* blo, int64_t P,
                               int64_t Q, int64_t n_pad, int64_t nr,
                               int64_t run, int64_t mode, int64_t keep_alive,
                               void* part, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (run < 1 || nr < kKC || nr % kKC || n_pad % nr || P % kRows || Q < 1 ||
      Q > kRows)
    return (int)cudaErrorInvalidValue;
  const int64_t runs = (n_pad / nr + run - 1) / run;
  const int64_t size = (kSlices * P) * (kSlices * Q);
  const float *a0 = (const float*)ahi, *a1 = (const float*)alo;
  const float *b0 = (const float*)bhi, *b1 = (const float*)blo;
  float* pp = (float*)part;
  const int keep = (int)keep_alive;
  int err;
  switch (mode) {
    case 0:
      err = launch<false, false>(a0, a1, b0, b1, P, Q, n_pad, nr, run, keep,
                                 pp, s);
      break;
    case 1:
      err = launch<true, false>(a0, a1, b0, b1, P, Q, n_pad, nr, run, keep,
                                pp, s);
      break;
    case 2:
      err = launch<false, true>(a0, a1, b0, b1, P, Q, n_pad, nr, run, keep,
                                pp, s);
      break;
    case 3:
      err = launch<true, true>(a0, a1, b0, b1, P, Q, n_pad, nr, run, keep, pp,
                               s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  if ((mode & 2) == 0)  // no dot: the slab is the zeros it started from
    return (int)cudaMemsetAsync(out, 0, size * sizeof(float), s);
  slice_gram_reduce<<<(unsigned)((size + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(pp, runs, size, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int gcge_bf16_mma_tile_check(const void* a, const void* b,
                                        void* d, void* stream) {
  constexpr int smem = 1024 + (64 + 112) * kKC * 2;  // under 48 KB
  bf16_mma_tile_check<<<1, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)d);
  return (int)cudaGetLastError();
}
