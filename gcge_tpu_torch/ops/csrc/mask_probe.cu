// One-hot mask probe on Hopper (kernel 7 of the port).
//
// Replaces gcge_tpu/ops/onehot_pallas.py:_bf16_mask_supported, the one-time
// probe that asks whether the TPU compiler lowers the bf16 form of the
// one-hot mask build, M[a, b] = (iota_a == ids[b]), with the compare and the
// select done on bf16 values.  This kernel computes the same function: from
// the first row of int32 ids (8, 128) it writes the (8, 128) bf16 mask
//
//   M[a, b] = (bf16(a) == bf16(ids[0, b])) ? bf16(1) : bf16(0)
//
// with the conversion, the compare (__heq) and the select on __nv_bfloat16.
// Integers below 2^8 are exact in bf16, so for ids in [0, 8) each column
// holds exactly one 1.  On Hopper the SpMM kernels gather and build no
// masks, so the answer picks no code path: CsrOperator.from_coo runs the
// probe once per operator built on a card and refuses a card that fails it.
//
// Bound: launch latency; the kernel reads the first row of ids (512 B) and
// writes 2 KB of mask.
//
// Plain C interface: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;
constexpr int COLS = 128;

__global__ void onehot_mask_probe_kernel(const int* __restrict__ ids,
                                         __nv_bfloat16* __restrict__ out) {
  const int b = threadIdx.x;
  const int a = threadIdx.y;
  const __nv_bfloat16 iota = __int2bfloat16_rn(a);
  const __nv_bfloat16 idb = __int2bfloat16_rn(ids[b]);
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  out[a * COLS + b] = __heq(iota, idb) ? one : zero;
}

}  // namespace

extern "C" int gcge_onehot_mask_probe(const void* ids, void* out,
                                      void* stream) {
  onehot_mask_probe_kernel<<<1, dim3(COLS, ROWS), 0, (cudaStream_t)stream>>>(
      (const int*)ids, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
