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
// dot adds 2 * 49 P Q n_pad = 3.17e10 FLOP; this first kernel does them as
// f32 FMAs on the CUDA cores (0.47 ms at 67 TFLOP/s), not on the tensor
// cores (0.032 ms at the bf16 rate), so `dot` and `full` are bound by
// operations.
//
// Design.  The TPU walks the chunks in order on one core and carries the slab
// in scratch memory.  Here a block owns one chunk and 16 rows of A against
// all (at most 16) rows of B: thread (pa, qb) keeps the 7 x 7 slice-pair
// sums of its (row of A, row of B) pair in registers.  The block walks its
// chunk in steps of 64 columns: 256 threads load and peel a (16 x 64) tile of
// each operand (one float4 of hi and of lo per thread and operand) into bf16
// stacks in shared memory, then each thread reads 7 + 7 slices per column and
// does 49 FMAs.  Chunk slabs go to scratch (G, 7P, 7Q) and a second kernel
// adds them in chunk order into one f32 sum, which is the TPU kernel's order
// of additions: no atomics, equal bits from launch to launch.  Products of
// two bf16 slices are exact in f32, so FMA and multiply-then-add agree, and
// where a chunk's sum stays below 2^24 units (7-bit slices do) the slab has
// the bits of the plain version.
//
// Keeping the work alive.  Without the dot nothing computed is stored, and
// nvcc deletes work whose result is never used.  The kernel ends with a store
// of one shared-memory slice per thread (and of a checksum of the lo plane in
// the modes that do not peel it) under `keep_alive`, a run-time argument that
// the wrapper always passes as 0: the compiler must keep every load, peel
// and shared-memory store, and the store itself never runs.
//
// Plain C interface: returns the first error of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlices = 7;
constexpr int kTP = 16;   // rows of A per block
constexpr int kTQ = 16;   // rows of B per block (all of them: Q <= 16)
constexpr int kKC = 64;   // columns per step
constexpr int kPad = 2;   // bf16 of padding per column of a stack

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

typedef __nv_bfloat16 Stack[kSlices][kKC][kTP + kPad];

// Load this thread's float4 of hi and lo (row `row` of the tile, columns
// 4 c4 .. 4 c4 + 3 of the step) and write its slices into the stack.
template <bool PEEL>
__device__ __forceinline__ void stage(const float* __restrict__ hi,
                                      const float* __restrict__ lo,
                                      bool row_ok, int64_t offset, int row,
                                      int c4, Stack& st, unsigned& sink) {
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f), l = h;
  if (row_ok) {
    h = *reinterpret_cast<const float4*>(hi + offset);
    l = *reinterpret_cast<const float4*>(lo + offset);
  }
  const float hv[4] = {h.x, h.y, h.z, h.w};
  const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * c4 + i;
    if (PEEL) {
      float s[kSlices];
      peel7(hv[i], lv[i], s);
#pragma unroll
      for (int k = 0; k < kSlices; ++k) st[k][c][row] = __float2bfloat16_rn(s[k]);
    } else {
      st[0][c][row] = __float2bfloat16_rn(hv[i]);
      sink ^= __float_as_uint(lv[i]);  // lo is loaded, as the TPU's block is
    }
  }
}

template <bool PEEL, bool DOT>
__global__ void slice_gram_partial(const float* __restrict__ ahi,
                                   const float* __restrict__ alo,
                                   const float* __restrict__ bhi,
                                   const float* __restrict__ blo, int64_t P,
                                   int64_t Q, int64_t n_pad, int64_t nr,
                                   int keep_alive, float* __restrict__ part) {
  __shared__ Stack sa;
  __shared__ Stack sb;
  const int tid = threadIdx.x;
  const int64_t g = blockIdx.x;                 // chunk
  const int64_t p0 = (int64_t)blockIdx.y * kTP; // first row of A
  const int row = tid / 16, c4 = tid % 16;      // staging role
  const int pa = tid / kTQ, qb = tid % kTQ;     // product role
  unsigned sink = 0;
  float acc[kSlices][kSlices];
#pragma unroll
  for (int ka = 0; ka < kSlices; ++ka)
#pragma unroll
    for (int kb = 0; kb < kSlices; ++kb) acc[ka][kb] = 0.f;
  if (!PEEL) {  // slices 1..6 stay zero
    __nv_bfloat16* za = &sa[1][0][0];
    __nv_bfloat16* zb = &sb[1][0][0];
    for (int e = tid; e < (kSlices - 1) * kKC * (kTP + kPad); e += kThreads) {
      za[e] = __float2bfloat16_rn(0.f);
      zb[e] = __float2bfloat16_rn(0.f);
    }
  }
  for (int64_t col0 = g * nr; col0 < (g + 1) * nr; col0 += kKC) {
    __syncthreads();  // the previous step's products are done with the stacks
    const int64_t col = col0 + 4 * c4;
    stage<PEEL>(ahi, alo, true, (p0 + row) * n_pad + col, row, c4, sa, sink);
    stage<PEEL>(bhi, blo, row < Q, row * n_pad + col, row, c4, sb, sink);
    __syncthreads();
    if (DOT) {
#pragma unroll 2
      for (int c = 0; c < kKC; ++c) {
        float av[kSlices], bv[kSlices];
#pragma unroll
        for (int k = 0; k < kSlices; ++k) {
          av[k] = __bfloat162float(sa[k][c][pa]);
          bv[k] = __bfloat162float(sb[k][c][qb]);
        }
#pragma unroll
        for (int ka = 0; ka < kSlices; ++ka)
#pragma unroll
          for (int kb = 0; kb < kSlices; ++kb)
            acc[ka][kb] = fmaf(av[ka], bv[kb], acc[ka][kb]);
      }
    }
  }
  if (DOT && qb < Q) {
    float* slab = part + g * (kSlices * P) * (kSlices * Q);
#pragma unroll
    for (int ka = 0; ka < kSlices; ++ka)
#pragma unroll
      for (int kb = 0; kb < kSlices; ++kb)
        slab[(ka * P + p0 + pa) * (kSlices * Q) + kb * Q + qb] = acc[ka][kb];
  }
  if (keep_alive != 0) {  // never true: see "Keeping the work alive"
    const int k = tid % kSlices, c = tid % kKC;
    part[(g * gridDim.y + blockIdx.y) * kThreads + tid] =
        __bfloat162float(sa[k][c][row]) + __bfloat162float(sb[k][c][row]) +
        __uint_as_float(sink);
  }
}

// out[t] = ((part[0][t] + part[1][t]) + part[2][t]) + ...: the order in which
// the TPU kernel adds its chunk slabs.
__global__ void slice_gram_reduce(const float* __restrict__ part, int64_t g,
                                  int64_t size, float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= size) return;
  float s = 0.f;
  for (int64_t k = 0; k < g; ++k) s = __fadd_rn(s, part[k * size + t]);
  out[t] = s;
}

}  // namespace

// P a multiple of 16, 1 <= Q <= 16, nr a multiple of 64, n_pad a multiple of
// nr, planes contiguous and 16-byte aligned (the wrapper checks); part holds
// (n_pad / nr) * 7P * 7Q floats, out 7P * 7Q.
extern "C" int gcge_slice_gram(const void* ahi, const void* alo,
                               const void* bhi, const void* blo, int64_t P,
                               int64_t Q, int64_t n_pad, int64_t nr,
                               int64_t mode, int64_t keep_alive, void* part,
                               void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t g = n_pad / nr;
  const int64_t size = (kSlices * P) * (kSlices * Q);
  const dim3 grid((unsigned)g, (unsigned)(P / kTP));
  const float *a0 = (const float*)ahi, *a1 = (const float*)alo;
  const float *b0 = (const float*)bhi, *b1 = (const float*)blo;
  float* pp = (float*)part;
  const int keep = (int)keep_alive;
  switch (mode) {
    case 0:
      slice_gram_partial<false, false><<<grid, kThreads, 0, s>>>(
          a0, a1, b0, b1, P, Q, n_pad, nr, keep, pp);
      break;
    case 1:
      slice_gram_partial<true, false><<<grid, kThreads, 0, s>>>(
          a0, a1, b0, b1, P, Q, n_pad, nr, keep, pp);
      break;
    case 2:
      slice_gram_partial<false, true><<<grid, kThreads, 0, s>>>(
          a0, a1, b0, b1, P, Q, n_pad, nr, keep, pp);
      break;
    case 3:
      slice_gram_partial<true, true><<<grid, kThreads, 0, s>>>(
          a0, a1, b0, b1, P, Q, n_pad, nr, keep, pp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if ((mode & 2) == 0)  // no dot: the slab is the zeros it started from
    return (int)cudaMemsetAsync(out, 0, size * sizeof(float), s);
  slice_gram_reduce<<<(unsigned)((size + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(pp, g, size, (float*)out);
  return (int)cudaGetLastError();
}
