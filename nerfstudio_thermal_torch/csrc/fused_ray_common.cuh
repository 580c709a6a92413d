// Device code shared by the fused ray-march and whole-field kernels
// (fused_ray_fwd.cu, fused_ray_bwd.cu): the per-point ray prologue
// (position, inf-norm contraction, (x + 2) / 4, in-box selector), the
// contraction's VJP, degree-4 SH of a direction and its VJP, and the
// per-ray sums of the backward. The plain PyTorch versions, with the same
// operations in the same order, are in ops/cuda/fused_ray.py.
//
// Every product, quotient and sum here is an IEEE-rounded intrinsic
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn): nvcc would otherwise
// contract a * b + c into an FMA, which the plain versions (separate
// elementwise operations) do not do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T ray_cast(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}
__device__ __forceinline__ float ray_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ray_f32(float v) { return v; }

// One sample of a ray: pos = o + t d, then (TPU fused_mlp.py
// _contract_fwd) mag = max |pos_k|, safe = max(mag, 1e-12), the contracted
// position (2 - 1 / safe) (pos / safe) where mag >= 1, p01 = (c + 2) / 4,
// sel = all(0 < p01 < 1), x = p01 sel.
struct RayPoint {
  float pos[3];
  float x[3];
  float sel, mag, safe;
};

__device__ __forceinline__ void ray_point(const float* __restrict__ o, const float* __restrict__ d,
                                          float t, RayPoint& p) {
  float mag = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.pos[k] = __fadd_rn(o[k], __fmul_rn(t, d[k]));
    mag = fmaxf(mag, fabsf(p.pos[k]));
  }
  const float safe = fmaxf(mag, 1e-12f);
  const float scale = __fsub_rn(2.f, __fdiv_rn(1.f, safe));
  bool in = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = mag < 1.f ? p.pos[k] : __fmul_rn(scale, __fdiv_rn(p.pos[k], safe));
    p.x[k] = __fmul_rn(__fadd_rn(c, 2.f), 0.25f);
    in = in && p.x[k] > 0.f && p.x[k] < 1.f;
  }
  p.sel = in ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) p.x[k] = __fmul_rn(p.x[k], p.sel);
  p.mag = mag;
  p.safe = safe;
}

// VJP of x with respect to pos (TPU _contract_bwd): g = dx sel / 4; inside
// the unit ball d_pos = g; outside, with m = safe and s_k = sign(pos_k) for
// the components that reach the inf-norm (every tied one), zero otherwise:
// d_pos_k = g_k (2/m - 1/m^2) + (g . pos) (2/m^3 - 2/m^2) s_k.
__device__ __forceinline__ void contract_bwd(const RayPoint& p, const float* __restrict__ dx,
                                             float* d_pos) {
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = __fmul_rn(__fmul_rn(dx[k], p.sel), 0.25f);
  if (p.mag < 1.f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d_pos[k] = g[k];
    return;
  }
  const float m = p.safe;
  const float mm = __fmul_rn(m, m);
  float gdotx = __fmul_rn(g[0], p.pos[0]);
  gdotx = __fadd_rn(gdotx, __fmul_rn(g[1], p.pos[1]));
  gdotx = __fadd_rn(gdotx, __fmul_rn(g[2], p.pos[2]));
  const float a = __fsub_rn(__fdiv_rn(2.f, m), __fdiv_rn(1.f, mm));
  const float b = __fsub_rn(__fdiv_rn(2.f, __fmul_rn(mm, m)), __fdiv_rn(2.f, mm));
  const float gb = __fmul_rn(gdotx, b);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float v = p.pos[k];
    const float s = fabsf(v) >= p.mag ? (v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f)) : 0.f;
    d_pos[k] = __fadd_rn(__fmul_rn(g[k], a), __fmul_rn(gb, s));
  }
}

// SH constants (TPU fused_mlp.py _sh4_2d, ops/encodings.py sh_encoding)
#define SH_C0 0.28209479177387814f
#define SH_C1 0.4886025119029199f
#define SH_C4 1.0925484305920792f
#define SH_C6 0.9461746957575601f
#define SH_C6B 0.31539156525251999f
#define SH_C8 0.5462742152960396f
#define SH_C9 0.5900435899266435f
#define SH_C10 2.890611442640554f
#define SH_C11 0.4570457994644658f
#define SH_C12 0.3731763325901154f
#define SH_C14 1.445305721320277f

// Degree-4 real SH of a unit direction, the products in _sh4_2d's order.
__device__ __forceinline__ void sh4(const float* __restrict__ dir, float* s) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  s[0] = SH_C0;
  s[1] = __fmul_rn(SH_C1, y);
  s[2] = __fmul_rn(SH_C1, z);
  s[3] = __fmul_rn(SH_C1, x);
  s[4] = __fmul_rn(__fmul_rn(SH_C4, x), y);
  s[5] = __fmul_rn(__fmul_rn(SH_C4, y), z);
  s[6] = __fsub_rn(__fmul_rn(SH_C6, zz), SH_C6B);
  s[7] = __fmul_rn(__fmul_rn(SH_C4, x), z);
  s[8] = __fmul_rn(SH_C8, __fsub_rn(xx, yy));
  s[9] = __fmul_rn(__fmul_rn(SH_C9, y), __fsub_rn(__fmul_rn(3.f, xx), yy));
  s[10] = __fmul_rn(__fmul_rn(__fmul_rn(SH_C10, x), y), z);
  s[11] = __fmul_rn(__fmul_rn(SH_C11, y), __fsub_rn(__fmul_rn(5.f, zz), 1.f));
  s[12] = __fmul_rn(__fmul_rn(SH_C12, z), __fsub_rn(__fmul_rn(5.f, zz), 3.f));
  s[13] = __fmul_rn(__fmul_rn(SH_C11, x), __fsub_rn(__fmul_rn(5.f, zz), 1.f));
  s[14] = __fmul_rn(__fmul_rn(SH_C14, z), __fsub_rn(xx, yy));
  s[15] = __fmul_rn(__fmul_rn(SH_C9, x), __fsub_rn(xx, __fmul_rn(3.f, yy)));
}

// VJP of sh4: out[k] = sum over components c (ascending) of g_c dSH_c/d_k,
// each partial a product chain in the order of fused_ray.py sh4_vjp.
__device__ __forceinline__ void sh4_vjp(const float* __restrict__ dir, const float* __restrict__ g,
                                        float* out) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float zz5m1 = __fsub_rn(__fmul_rn(zz, 5.f), 1.f);
  const float zz15m3 = __fsub_rn(__fmul_rn(zz, 15.f), 3.f);
  const float xx3yy3 = __fsub_rn(__fmul_rn(xx, 3.f), __fmul_rn(yy, 3.f));
  const float xxyy = __fsub_rn(xx, yy);
#define SH_TERM(k, v) __fmul_rn(g[k], (v))
  float dx = SH_TERM(3, SH_C1);
  dx = __fadd_rn(dx, SH_TERM(4, __fmul_rn(SH_C4, y)));
  dx = __fadd_rn(dx, SH_TERM(7, __fmul_rn(SH_C4, z)));
  dx = __fadd_rn(dx, SH_TERM(8, __fmul_rn(__fmul_rn(SH_C8, x), 2.f)));
  dx = __fadd_rn(dx, SH_TERM(9, __fmul_rn(__fmul_rn(__fmul_rn(SH_C9, x), y), 6.f)));
  dx = __fadd_rn(dx, SH_TERM(10, __fmul_rn(__fmul_rn(SH_C10, y), z)));
  dx = __fadd_rn(dx, SH_TERM(13, __fmul_rn(SH_C11, zz5m1)));
  dx = __fadd_rn(dx, SH_TERM(14, __fmul_rn(__fmul_rn(__fmul_rn(SH_C14, x), z), 2.f)));
  dx = __fadd_rn(dx, SH_TERM(15, __fmul_rn(SH_C9, xx3yy3)));
  float dy = SH_TERM(1, SH_C1);
  dy = __fadd_rn(dy, SH_TERM(4, __fmul_rn(SH_C4, x)));
  dy = __fadd_rn(dy, SH_TERM(5, __fmul_rn(SH_C4, z)));
  dy = __fadd_rn(dy, SH_TERM(8, __fmul_rn(__fmul_rn(SH_C8, y), -2.f)));
  dy = __fadd_rn(dy, SH_TERM(9, __fmul_rn(SH_C9, xx3yy3)));
  dy = __fadd_rn(dy, SH_TERM(10, __fmul_rn(__fmul_rn(SH_C10, x), z)));
  dy = __fadd_rn(dy, SH_TERM(11, __fmul_rn(SH_C11, zz5m1)));
  dy = __fadd_rn(dy, SH_TERM(14, __fmul_rn(__fmul_rn(__fmul_rn(SH_C14, y), z), -2.f)));
  dy = __fadd_rn(dy, SH_TERM(15, __fmul_rn(__fmul_rn(__fmul_rn(SH_C9, x), y), -6.f)));
  float dz = SH_TERM(2, SH_C1);
  dz = __fadd_rn(dz, SH_TERM(5, __fmul_rn(SH_C4, y)));
  dz = __fadd_rn(dz, SH_TERM(6, __fmul_rn(__fmul_rn(SH_C6, z), 2.f)));
  dz = __fadd_rn(dz, SH_TERM(7, __fmul_rn(SH_C4, x)));
  dz = __fadd_rn(dz, SH_TERM(10, __fmul_rn(__fmul_rn(SH_C10, x), y)));
  dz = __fadd_rn(dz, SH_TERM(11, __fmul_rn(__fmul_rn(__fmul_rn(SH_C11, y), z), 10.f)));
  dz = __fadd_rn(dz, SH_TERM(12, __fmul_rn(SH_C12, zz15m3)));
  dz = __fadd_rn(dz, SH_TERM(13, __fmul_rn(__fmul_rn(__fmul_rn(SH_C11, x), z), 10.f)));
  dz = __fadd_rn(dz, SH_TERM(14, __fmul_rn(SH_C14, xxyy)));
#undef SH_TERM
  out[0] = dx;
  out[1] = dy;
  out[2] = dz;
}

// Per point: x = p01 sel into x [n, 3] f32 (the backward's recompute of
// the stack's input).
__global__ void ray_prologue(const float* __restrict__ o, const float* __restrict__ d,
                             const float* __restrict__ t, float* __restrict__ x, int n, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = i / S;
  RayPoint p;
  ray_point(o + 3 * r, d + 3 * r, t[i], p);
#pragma unroll
  for (int k = 0; k < 3; ++k) x[3 * i + k] = p.x[k];
}

}  // namespace
