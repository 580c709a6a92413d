// Multiresolution hash-grid encoding for Hopper (sm_90a): forward, table
// gradient and position gradient, bound to Python through a plain C
// interface (ctypes). Wrapper, autograd node and the launch checks live in
// nerfstudio_thermal_torch/ops/cuda/hash_encoding.py; the plain PyTorch
// versions of the same three functions in nerfstudio_thermal_torch/ops/
// encodings.py.
//
// Function (nerfstudio_thermal_tpu/ops/encodings.py:hash_encode and its
// custom VJP): for point n and level l, scaled_d = pos[n, d] * scaling[l]
// (one f32 product), the cell corners floor(scaled_d) and ceil(scaled_d)
// (ceil, not floor + 1: at an integer coordinate both corners are the same
// row, with weights 1 and 0), the hash (uint32(int32(corner_d)) * prime_d,
// primes 1, 2654435761, 805459861, XORed, masked to T - 1) plus l * T as the
// table row, the trilinear weight (w_x * w_y) * w_z with w = 1 - offset for
// the floor corner and offset for the ceil corner, and out[n, l*2 + f] =
// sum over the 8 corners, in corner order 0..7 (bit 2: x, bit 1: y, bit 0:
// z; 1 = ceil), of table[row, f] * w, in f32, rounded to the output type
// last. F = 2 features per level only.
//
// Replaces the TPU kernels (nerfstudio_thermal_tpu/ops/pallas/):
// - hash_encode_fwd: hash_encoding.py:_fwd_kernel (the one-hot matmul
//   forward of hash_encode_pallas, T <= 4096) and the XLA row gather that
//   forms the forward of hash_gather.py:hash_encode_hybrid (large tables).
// - hash_encode_bwd_table: d_table = sum of g * w scattered to the 8 corner
//   rows of every level: hash_gather.py:_bwd_table_kernel (via
//   _scatter_mxu) and hash_encoding.py:_bwd_table_kernel. The spec is
//   hash_encode's f32 scatter: the hybrid's rounding of g * w to bf16 before
//   its MXU pass is not copied.
// - hash_encode_bwd_pos: d_pos[n, d] = sum_l scaling[l] * sum_c (g . row_c)
//   * (+-1) * (product of the other two weights): hash_encoding.py:
//   _bwd_pos_kernel. It re-gathers the corner rows instead of keeping the
//   hybrid's [8, L, N, F] residual stack.
// A one-hot matmul is the TPU's way around having no vector gather; Hopper
// has gathers and atomics, so these kernels gather and scatter directly.
//
// What bounds them: bytes. Per point and level the forward does ~60 flops
// and 8 random 8-byte row reads; the function itself has to move only the
// positions (12 B per point), the table once (64 MiB for 16 x 2^19 x 2 f32)
// and the output, so at 3.35 TB/s the base field's 393,216 points take
// ~0.03 ms. The random rows are what the kernels really pay for: each row
// read or atomic touches a 32-byte sector, the fine levels of a 64 MiB
// table miss the 50 MB L2, and coarse levels put many points on the same
// rows (atomic contention in the table gradient).
//
// Design (simple first): one thread per (point, level), point-major, so a
// warp writes consecutive output pairs; the 8 corners are unrolled so that
// their 8 row loads (or atomics) are in flight together; each row is one
// 8-byte float2 load. The table gradient adds g * w to each corner row with
// the sm_90 vector atomicAdd on float2, in f32, and skips a (point, level)
// whose two g values are both zero (those would add only zeros). The
// position gradient runs one thread per point, looping over the levels,
// with no atomics. Left for later: staging the coarse levels in shared
// memory, sorting points by cell, warp-aggregated atomics.
//
// Numerics: products and sums use __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc cannot contract them into FMAs: the forward and the position
// gradient round exactly as the plain versions' separate multiplies and
// adds. The table gradient's atomics add in an order that changes from run
// to run, so its sums agree with the plain version's only to f32 rounding
// of a reordered sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
  uint32_t hf[3], hc[3];  // hashed floor / ceil coordinate per dimension
  float wf[3], wc[3];     // weight of the floor / ceil corner per dimension
};

__device__ __forceinline__ void corner_factors(const float p[3], float scaling, Corners& k) {
  const uint32_t primes[3] = {1u, 2654435761u, 805459861u};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float scaled = __fmul_rn(p[d], scaling);
    const float fl = floorf(scaled);
    const float off = __fsub_rn(scaled, fl);
    k.hf[d] = (uint32_t)(int)fl * primes[d];
    k.hc[d] = (uint32_t)(int)ceilf(scaled) * primes[d];
    k.wf[d] = __fsub_rn(1.f, off);
    k.wc[d] = off;
  }
}

__device__ __forceinline__ uint32_t corner_row(const Corners& k, int c, uint32_t mask) {
  return (((c & 4) ? k.hc[0] : k.hf[0]) ^ ((c & 2) ? k.hc[1] : k.hf[1]) ^
          ((c & 1) ? k.hc[2] : k.hf[2])) & mask;
}

__device__ __forceinline__ float corner_weight(const Corners& k, int c) {
  return __fmul_rn(__fmul_rn((c & 4) ? k.wc[0] : k.wf[0], (c & 2) ? k.wc[1] : k.wf[1]),
                   (c & 1) ? k.wc[2] : k.wf[2]);
}

__device__ __forceinline__ void load_point(const float* __restrict__ pos, long long n, float p[3]) {
  p[0] = __ldg(pos + 3 * n);
  p[1] = __ldg(pos + 3 * n + 1);
  p[2] = __ldg(pos + 3 * n + 2);
}

template <bool kBf16>
__device__ __forceinline__ float2 load_g(const void* __restrict__ g, long long i) {
  if (kBf16) {
    const __nv_bfloat162 v = reinterpret_cast<const __nv_bfloat162*>(g)[i];
    return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
  }
  return reinterpret_cast<const float2*>(g)[i];
}

// out[n, 2l + f], one thread per (point n, level l), i = n * L + l.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                           const float* __restrict__ scalings, void* __restrict__ out,
                           long long total, int num_levels, int log2_t) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long n = i / num_levels;
  const int l = (int)(i - n * num_levels);
  float p[3];
  load_point(pos, n, p);
  Corners k;
  corner_factors(p, __ldg(scalings + l), k);
  const uint32_t mask = (1u << log2_t) - 1u;
  const float2* tl = table + ((size_t)l << log2_t);
  float2 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __ldg(tl + corner_row(k, c, mask));
  float o0 = 0.f, o1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(k, c);
    o0 = __fadd_rn(o0, __fmul_rn(v[c].x, w));
    o1 = __fadd_rn(o1, __fmul_rn(v[c].y, w));
  }
  if (kBf16) {
    reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(o0, o1);
  } else {
    reinterpret_cast<float2*>(out)[i] = make_float2(o0, o1);
  }
}

// d_table[row] += g[n, 2l + f] * w, one thread per (point, level).
template <bool kBf16G>
__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_table_kernel(const float* __restrict__ pos, const void* __restrict__ g,
                                 const float* __restrict__ scalings, float2* __restrict__ dtable,
                                 long long total, int num_levels, int log2_t) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float2 gv = load_g<kBf16G>(g, i);
  if (gv.x == 0.f && gv.y == 0.f) return;  // would add only zeros
  const long long n = i / num_levels;
  const int l = (int)(i - n * num_levels);
  float p[3];
  load_point(pos, n, p);
  Corners k;
  corner_factors(p, __ldg(scalings + l), k);
  const uint32_t mask = (1u << log2_t) - 1u;
  float2* dl = dtable + ((size_t)l << log2_t);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(k, c);
    atomicAdd(dl + corner_row(k, c, mask), make_float2(__fmul_rn(gv.x, w), __fmul_rn(gv.y, w)));
  }
}

// d_pos[n, d], one thread per point, looping over the levels.
template <bool kBf16G>
__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_pos_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                               const void* __restrict__ g, const float* __restrict__ scalings,
                               float* __restrict__ dpos, long long n_points, int num_levels,
                               int log2_t) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  float p[3];
  load_point(pos, n, p);
  const uint32_t mask = (1u << log2_t) - 1u;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < num_levels; ++l) {
    const float2 gv = load_g<kBf16G>(g, n * num_levels + l);
    const float scaling = __ldg(scalings + l);
    Corners k;
    corner_factors(p, scaling, k);
    const float2* tl = table + ((size_t)l << log2_t);
    float2 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = __ldg(tl + corner_row(k, c, mask));
    float d_off[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float gdf = __fadd_rn(__fmul_rn(gv.x, v[c].x), __fmul_rn(gv.y, v[c].y));
      const float wx = (c & 4) ? k.wc[0] : k.wf[0];
      const float wy = (c & 2) ? k.wc[1] : k.wf[1];
      const float wz = (c & 1) ? k.wc[2] : k.wf[2];
      const float sx = (c & 4) ? gdf : -gdf;
      const float sy = (c & 2) ? gdf : -gdf;
      const float sz = (c & 1) ? gdf : -gdf;
      d_off[0] = __fadd_rn(d_off[0], __fmul_rn(__fmul_rn(sx, wy), wz));
      d_off[1] = __fadd_rn(d_off[1], __fmul_rn(__fmul_rn(sy, wx), wz));
      d_off[2] = __fadd_rn(d_off[2], __fmul_rn(__fmul_rn(sz, wx), wy));
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] = __fadd_rn(acc[d], __fmul_rn(d_off[d], scaling));
  }
  dpos[3 * n] = acc[0];
  dpos[3 * n + 1] = acc[1];
  dpos[3 * n + 2] = acc[2];
}

unsigned int blocks(long long threads) { return (unsigned int)((threads + kThreads - 1) / kThreads); }

bool bad_shape(long long n, int num_levels, int log2_t) {
  return n <= 0 || num_levels <= 0 || log2_t < 0 || log2_t > 30;
}

}  // namespace

// Each function returns the cudaError_t of its launch (0 on success). The
// pointers are device pointers: pos [n, 3] f32, table and d_table
// [L * 2^log2_t, 2] f32, scalings [L] f32, out and g [n, 2L] in bf16 (flag
// 1) or f32 (flag 0), d_pos [n, 3] f32. d_table must be zeroed by the
// caller; the other outputs are written in full.
extern "C" int hash_encode_fwd(const void* pos, const void* table, const void* scalings,
                               void* out, long long n, int num_levels, int log2_t,
                               int out_bf16, int device, void* stream) {
  if (bad_shape(n, num_levels, log2_t)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long total = n * num_levels;
  const float* p = static_cast<const float*>(pos);
  const float2* t = static_cast<const float2*>(table);
  const float* sc = static_cast<const float*>(scalings);
  if (out_bf16) {
    hash_encode_fwd_kernel<true><<<blocks(total), kThreads, 0, s>>>(p, t, sc, out, total, num_levels, log2_t);
  } else {
    hash_encode_fwd_kernel<false><<<blocks(total), kThreads, 0, s>>>(p, t, sc, out, total, num_levels, log2_t);
  }
  return (int)cudaGetLastError();
}

extern "C" int hash_encode_bwd_table(const void* pos, const void* g, const void* scalings,
                                     void* dtable, long long n, int num_levels, int log2_t,
                                     int g_bf16, int device, void* stream) {
  if (bad_shape(n, num_levels, log2_t)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long total = n * num_levels;
  const float* p = static_cast<const float*>(pos);
  const float* sc = static_cast<const float*>(scalings);
  float2* dt = static_cast<float2*>(dtable);
  if (g_bf16) {
    hash_encode_bwd_table_kernel<true><<<blocks(total), kThreads, 0, s>>>(p, g, sc, dt, total, num_levels, log2_t);
  } else {
    hash_encode_bwd_table_kernel<false><<<blocks(total), kThreads, 0, s>>>(p, g, sc, dt, total, num_levels, log2_t);
  }
  return (int)cudaGetLastError();
}

extern "C" int hash_encode_bwd_pos(const void* pos, const void* table, const void* g,
                                   const void* scalings, void* dpos, long long n, int num_levels,
                                   int log2_t, int g_bf16, int device, void* stream) {
  if (bad_shape(n, num_levels, log2_t)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float2* t = static_cast<const float2*>(table);
  const float* sc = static_cast<const float*>(scalings);
  float* dp = static_cast<float*>(dpos);
  if (g_bf16) {
    hash_encode_bwd_pos_kernel<true><<<blocks(n), kThreads, 0, s>>>(p, t, g, sc, dp, n, num_levels, log2_t);
  } else {
    hash_encode_bwd_pos_kernel<false><<<blocks(n), kThreads, 0, s>>>(p, t, g, sc, dp, n, num_levels, log2_t);
  }
  return (int)cudaGetLastError();
}
