// bf16 mma.sync building blocks shared by the fused-MLP forward and
// backward (fused_mlp_fwd.cu, fused_mlp_bwd.cu): the m16n8k16 product, the
// ldmatrix A-fragment load, bf16 pair packing, and one warp's 16-row product
// against weights packed in mma B-fragment order (fused_mlp.py
// _fragment_index).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[16 rows, 8 n-tiles] = A[16 rows, 16 kt_n] B, one warp: A as mma
// A fragments per 16-wide k-tile, B packed in mma B-fragment order
// (np_n n-tile pairs per k-tile) in shared memory.
__device__ __forceinline__ void warp_product(const uint32_t (&a)[4][4], int kt_n, const uint4* wl,
                                             int np_n, float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    if (kt < kt_n) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p < np_n) {
          const uint4 bv = wl[(kt * np_n + p) * 32 + lane];
          mma_bf16(acc[2 * p], a[kt], bv.x, bv.y);
          mma_bf16(acc[2 * p + 1], a[kt], bv.z, bv.w);
        }
      }
    }
  }
}

}  // namespace
