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
// What bounds them: the random rows. Per point and level the forward does
// ~60 flops and 8 random 8-byte row reads; the function itself has to move
// only the positions (12 B per point), the table rows it touches and the
// output, so at 3.35 TB/s a thermal-nerfacto render chunk's 8 calls take
// ~0.37 ms. What the kernels pay for is the rows: each row read or atomic
// touches a 32-byte sector, the fine levels of a 64 MiB table miss the
// 50 MB L2, and the model's points are ray-major (the samples of one ray
// consecutive and sorted by depth, neighbouring rays neighbouring pixels),
// so neighbouring points fall in the same cells at every coarse level: the
// same rows again and again, and in the table gradient atomics that
// serialise on those rows in L2.
//
// Mapping (forward and table gradient): a block owns a tile of G groups of
// 32 consecutive points; its warps take the tile's (group, level) items in
// turn, item = level * G + group, lane = point. So one warp-wide gather of
// corner c at level l covers 32 consecutive samples of one or two rays at
// one level: at the coarse levels those lanes fall on a few sectors, which
// the memory system merges within the instruction (the first design ran one
// thread per (point, level), point-major, so a warp's 32 lanes spanned 16
// level slices and never shared a sector). And the warps that work at the
// same time cover 32 * G consecutive points (several neighbouring rays) at
// one or two levels, whose rows meet again in L1. The [32 G, 2L] tile of the
// output (forward) or of the cotangent g (table gradient) is staged in
// shared memory, so that device memory sees it contiguous, 16 bytes a
// thread; a lane's store or load of its (point, level) pair would stride by
// 2L elements. The tile's rows are padded to an odd number of pairs
// (tile_stride), so a warp's 32 pairs of one level fall in distinct banks.
//
// Sizing, measured on the model's points (H100 80GB HBM3, 700 W; a
// thermal-nerfacto render chunk and training step, ms per chunk / step):
// - forward G = 8, 16 warps (256 points, 8 levels a warp at L = 16, the
//   block at two levels at a time): 2.09 ms per chunk. G = 16 read 2.05
//   (twice the shared memory: 70 KB a block in f32), G = 32 4.34 (three
//   blocks an SM), G = 4 2.37, G = 2 3.21, G = 1 3.38, G = 4 with 8 or 4
//   warps 3.13 / 3.65; one thread per point looping over all levels with
//   two levels' 16 loads in flight, 128-point tiles: 4.18 (the first
//   design: 3.05-3.08). Likely reasons, not measured apart: few points at
//   one level at a time leave the rows' reuse to L2, and a thread that walks
//   all 16 levels alone keeps too few loads in flight.
// - table gradient G = 1, 16 warps (32 points, one level a warp): 2.65-2.69
//   ms per step; G = 2 2.72, G = 4 2.82-2.85 (16 warps) or 2.93 / 3.17-3.20
//   (8 / 4 warps), G = 8 2.96, one thread per point looping over the levels
//   3.04 (the first design: 6.42-6.61). A likely reason, not measured
//   apart: its atomics return nothing to wait for, so it gains from more
//   warps in flight rather than from L1 reuse.
//
// Aggregation (table gradient): for each corner the warp's lanes are
// grouped by their row with __match_any_sync; each group's contributions
// are summed in f32 by a shuffle tree (sum_peers), and the group's lowest
// lane issues one float2 atomicAdd (the sm_90 vector atomic; with an unused
// result it compiles to a RED). Contention is one atomic per distinct row
// per warp instead of one per lane: the proposals' 5-level scatters, whose
// warps lie on one ray, fell from 1.62 / 0.45 to 0.18 / 0.08 ms. A lane
// whose g is zero at a level adds nothing (it joins no group), and a warp
// whose g is zero at a level skips the level. Two corners of one thread on
// the same row (an integer coordinate: floor = ceil) are separate groups
// of separate corners, so both are added, one with weight 0, as in the
// plain version. Left untried: a per-block shared-memory accumulator of a
// level's rows, flushed once per distinct row (it would merge rows across
// warps too). The base field's 16-level scatter still takes 0.56 ms
// (0.93 before); how much of it its fine levels take, whose rows rarely
// repeat within a warp, is not measured.
//
// The position gradient keeps the first design: one thread per point,
// looping over the levels, no atomics.
//
// Numerics: products and sums use __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc cannot contract them into FMAs: the forward and the position
// gradient round exactly as the plain versions' separate multiplies and
// adds (the forward's corners are summed in order 0..7 as before). The
// table gradient sums a group's terms in a shuffle tree and its atomics in
// an order that changes from run to run, so its sums agree with the plain
// version's only to f32 rounding of a reordered sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the position gradient's block
// The forward's and the table gradient's tiles: G groups of 32 consecutive
// points, one point per lane; a block of at most kMaxWarps warps takes the
// tile's G * L (group, level) items in turn, item = level * G + group, warp
// w the items w, w + warps, ..., with as many warps as spread the items
// evenly (tile_warps).
constexpr int kFwdGroups = 8, kBwdGroups = 1;
constexpr int kMaxWarps = 16;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane that adds nothing (rows are < 2^30)

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

// One (point, level) pair of features: float2 for f32, __nv_bfloat162 for
// bf16.
template <bool kBf16>
struct PairOf {
  using T = float2;
};
template <>
struct PairOf<true> {
  using T = __nv_bfloat162;
};

// Row stride of a staged [32 G, 2L] tile, in pairs: L, or L + 1 when L is
// even. An odd stride puts the 32 lanes' pairs of one level (lane = point)
// in 32 distinct 4-byte words (bf16) or, per half-warp, 16 distinct 8-byte
// words (f32): no bank conflict.
__host__ __device__ __forceinline__ int tile_stride(int num_levels) { return num_levels | 1; }

__host__ __device__ __forceinline__ size_t tile_bytes(int groups, int num_levels, size_t pair_bytes) {
  return (size_t)32 * groups * tile_stride(num_levels) * pair_bytes;
}

// Warps of a block for G * L items: the fewest items a warp can take with
// at most kMaxWarps warps, then the fewest warps that take them all.
__host__ __forceinline__ int tile_warps(int groups, int num_levels) {
  const int items = groups * num_levels;
  const int per_warp = (items + kMaxWarps - 1) / kMaxWarps;
  return (items + per_warp - 1) / per_warp;
}

// The tile's rows * L pairs are contiguous in device memory at `global`
// (16-byte aligned: the tile starts at a multiple of 32 rows of 2L
// elements). Pair q is (row q / L, level q % L), at row * stride + level in
// shared memory. A thread moves 16 bytes (kVec pairs) at a time; the last
// rows * L % kVec pairs one by one.
template <typename Pair>
__device__ __forceinline__ void copy_tile_out(const Pair* __restrict__ tile, Pair* __restrict__ global,
                                              int rows, int num_levels) {
  constexpr int kVec = 16 / sizeof(Pair);
  const int stride = tile_stride(num_levels);
  const int pairs = rows * num_levels;
  const int chunks = pairs / kVec;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    int q = i * kVec, r = q / num_levels, l = q - r * num_levels;
    union {
      uint4 u;
      Pair p[kVec];
    } v;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v.p[j] = tile[r * stride + l];
      if (++l == num_levels) { l = 0; ++r; }
    }
    reinterpret_cast<uint4*>(global)[i] = v.u;
  }
  for (int q = chunks * kVec + threadIdx.x; q < pairs; q += blockDim.x) {
    const int r = q / num_levels;
    global[q] = tile[r * stride + (q - r * num_levels)];
  }
}

// The inverse of copy_tile_out: the tile's pairs from device memory into
// shared memory.
template <typename Pair>
__device__ __forceinline__ void copy_tile_in(Pair* __restrict__ tile, const Pair* __restrict__ global,
                                             int rows, int num_levels) {
  constexpr int kVec = 16 / sizeof(Pair);
  const int stride = tile_stride(num_levels);
  const int pairs = rows * num_levels;
  const int chunks = pairs / kVec;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    union {
      uint4 u;
      Pair p[kVec];
    } v;
    v.u = __ldg(reinterpret_cast<const uint4*>(global) + i);
    int q = i * kVec, r = q / num_levels, l = q - r * num_levels;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      tile[r * stride + l] = v.p[j];
      if (++l == num_levels) { l = 0; ++r; }
    }
  }
  for (int q = chunks * kVec + threadIdx.x; q < pairs; q += blockDim.x) {
    const int r = q / num_levels;
    tile[r * stride + (q - r * num_levels)] = global[q];
  }
}

// One level of one point: the 8 corners' rows gathered, then summed in
// corner order 0..7.
__device__ __forceinline__ void gather_level(const float2* __restrict__ tl, const Corners& k, uint32_t mask,
                                             float2 v[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __ldg(tl + corner_row(k, c, mask));
}

__device__ __forceinline__ float2 trilerp(const Corners& k, const float2 v[8]) {
  float o0 = 0.f, o1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(k, c);
    o0 = __fadd_rn(o0, __fmul_rn(v[c].x, w));
    o1 = __fadd_rn(o1, __fmul_rn(v[c].y, w));
  }
  return make_float2(o0, o1);
}

template <bool kBf16>
__device__ __forceinline__ typename PairOf<kBf16>::T to_pair(float2 o) {
  if constexpr (kBf16) {
    return __floats2bfloat162_rn(o.x, o.y);
  } else {
    return o;
  }
}

template <bool kBf16>
__device__ __forceinline__ float2 from_pair(typename PairOf<kBf16>::T v) {
  if constexpr (kBf16) {
    return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
  } else {
    return v;
  }
}

// out[n, 2l + f]: block b owns the kGroups * 32 points from b * that; a
// warp's item is one level of 32 of them, lane = point; the output tile
// goes through shared memory.
template <int kGroups, bool kBf16>
__global__ void __launch_bounds__(32 * kMaxWarps)
    hash_encode_fwd_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                           const float* __restrict__ scalings, typename PairOf<kBf16>::T* __restrict__ out,
                           long long n_points, int num_levels, int log2_t) {
  using Pair = typename PairOf<kBf16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  Pair* tile = reinterpret_cast<Pair*>(smem);
  const long long n0 = (long long)blockIdx.x * (32 * kGroups);
  const int rows = (int)min((long long)(32 * kGroups), n_points - n0);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int stride = tile_stride(num_levels);
  const uint32_t mask = (1u << log2_t) - 1u;
  for (int item = threadIdx.x >> 5; item < kGroups * num_levels; item += warps) {
    const int l = item / kGroups, r = (item - l * kGroups) * 32 + lane;
    if (r >= rows) continue;
    float p[3];
    load_point(pos, n0 + r, p);
    Corners k;
    corner_factors(p, __ldg(scalings + l), k);
    float2 v[8];
    gather_level(table + ((size_t)l << log2_t), k, mask, v);
    tile[r * stride + l] = to_pair<kBf16>(trilerp(k, v));
  }
  __syncthreads();
  copy_tile_out(tile, out + n0 * num_levels, rows, num_levels);
}

// The sum of v over the lanes of `peers` (this lane's group: the lanes with
// the same row), left in the group's lowest lane: a shuffle tree, each lane
// adding the value of the next remaining peer above it, then dropping the
// peers whose rank has the current bit set. Every lane of the warp takes
// part; a lane alone in its group adds nothing.
__device__ __forceinline__ float2 sum_peers(uint32_t peers, int lane, float2 v) {
  uint32_t rank = __popc(peers & ((1u << lane) - 1u));
  uint32_t above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, 0 if none
    const float x = __shfl_sync(kFull, v.x, (next - 1) & 31);
    const float y = __shfl_sync(kFull, v.y, (next - 1) & 31);
    if (next) {
      v.x = __fadd_rn(v.x, x);
      v.y = __fadd_rn(v.y, y);
    }
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  return v;
}

// d_table[row] += g[n, 2l + f] * w: block b owns the kGroups * 32 points
// from b * that; a warp's item is one level of 32 of them, lane = point;
// g's tile comes through shared memory; per corner one atomic per distinct
// row of the warp.
template <int kGroups, bool kBf16G>
__global__ void __launch_bounds__(32 * kMaxWarps)
    hash_encode_bwd_table_kernel(const float* __restrict__ pos, const typename PairOf<kBf16G>::T* __restrict__ g,
                                 const float* __restrict__ scalings, float2* __restrict__ dtable,
                                 long long n_points, int num_levels, int log2_t) {
  using Pair = typename PairOf<kBf16G>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  Pair* tile = reinterpret_cast<Pair*>(smem);
  const long long n0 = (long long)blockIdx.x * (32 * kGroups);
  const int rows = (int)min((long long)(32 * kGroups), n_points - n0);
  copy_tile_in(tile, g + n0 * num_levels, rows, num_levels);
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int stride = tile_stride(num_levels);
  const uint32_t mask = (1u << log2_t) - 1u;
  for (int item = threadIdx.x >> 5; item < kGroups * num_levels; item += warps) {
    const int l = item / kGroups, r = (item - l * kGroups) * 32 + lane;
    const bool live = r < rows;
    const float2 gv = live ? from_pair<kBf16G>(tile[r * stride + l]) : make_float2(0.f, 0.f);
    const bool adds = gv.x != 0.f || gv.y != 0.f;  // a zero g would add only zeros
    if (!__any_sync(kFull, adds)) continue;
    float p[3] = {0.f, 0.f, 0.f};
    if (live) load_point(pos, n0 + r, p);
    Corners k;
    corner_factors(p, __ldg(scalings + l), k);
    float2* dl = dtable + ((size_t)l << log2_t);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t row = corner_row(k, c, mask);
      const float w = corner_weight(k, c);
      uint32_t peers = __match_any_sync(kFull, adds ? row : kNoRow);
      if (!adds) peers = 1u << lane;  // alone: no shuffle rounds for the lanes that add nothing
      const float2 sum = sum_peers(peers, lane, make_float2(__fmul_rn(gv.x, w), __fmul_rn(gv.y, w)));
      if (adds && lane == __ffs(peers) - 1) atomicAdd(dl + row, sum);
    }
  }
}

// d_pos[n, d], one thread per point, looping over the levels.
template <bool kBf16G>
__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_pos_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                               const typename PairOf<kBf16G>::T* __restrict__ g, const float* __restrict__ scalings,
                               float* __restrict__ dpos, long long n_points, int num_levels,
                               int log2_t) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  float p[3];
  load_point(pos, n, p);
  const uint32_t mask = (1u << log2_t) - 1u;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < num_levels; ++l) {
    const float2 gv = from_pair<kBf16G>(g[n * num_levels + l]);
    const float scaling = __ldg(scalings + l);
    Corners k;
    corner_factors(p, scaling, k);
    float2 v[8];
    gather_level(table + ((size_t)l << log2_t), k, mask, v);
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

// groups: the kernel's tile (0: none); its staged f32 tile must fit in
// shared memory.
bool bad_shape(long long n, int num_levels, int log2_t, int groups) {
  return n <= 0 || num_levels <= 0 || log2_t < 0 || log2_t > 30 ||
         tile_bytes(groups, num_levels, sizeof(float2)) > 232448;
}

// One launch of a tiled kernel (the forward or the table gradient) of
// `groups` * 32 points a block, the staged tile in dynamic shared memory
// (allowed above 48 KB where a large L needs it).
template <typename... Params, typename... Args>
cudaError_t launch_tiled(void (*kernel)(Params...), int groups, size_t pair_bytes, long long n, int num_levels,
                         cudaStream_t s, Args... args) {
  const size_t smem = tile_bytes(groups, num_levels, pair_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long points = 32LL * groups;
  kernel<<<(unsigned int)((n + points - 1) / points), 32 * tile_warps(groups, num_levels), smem, s>>>(
      args...);
  return cudaGetLastError();
}

}  // namespace

// Each function returns the cudaError_t of its launch (0 on success). The
// pointers are device pointers: pos [n, 3] f32, table and d_table
// [L * 2^log2_t, 2] f32, scalings [L] f32, out and g [n, 2L] in bf16 (flag
// 1) or f32 (flag 0), d_pos [n, 3] f32; out and g 16-byte aligned. d_table
// must be zeroed by the caller; the other outputs are written in full.
extern "C" int hash_encode_fwd(const void* pos, const void* table, const void* scalings,
                               void* out, long long n, int num_levels, int log2_t,
                               int out_bf16, int device, void* stream) {
  if (bad_shape(n, num_levels, log2_t, kFwdGroups)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float2* t = static_cast<const float2*>(table);
  const float* sc = static_cast<const float*>(scalings);
  if (out_bf16) {
    err = launch_tiled(hash_encode_fwd_kernel<kFwdGroups, true>, kFwdGroups, sizeof(__nv_bfloat162), n, num_levels,
                       s, p, t, sc, static_cast<__nv_bfloat162*>(out), n, num_levels, log2_t);
  } else {
    err = launch_tiled(hash_encode_fwd_kernel<kFwdGroups, false>, kFwdGroups, sizeof(float2), n, num_levels,
                       s, p, t, sc, static_cast<float2*>(out), n, num_levels, log2_t);
  }
  return (int)err;
}

extern "C" int hash_encode_bwd_table(const void* pos, const void* g, const void* scalings,
                                     void* dtable, long long n, int num_levels, int log2_t,
                                     int g_bf16, int device, void* stream) {
  if (bad_shape(n, num_levels, log2_t, kBwdGroups)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* sc = static_cast<const float*>(scalings);
  float2* dt = static_cast<float2*>(dtable);
  if (g_bf16) {
    err = launch_tiled(hash_encode_bwd_table_kernel<kBwdGroups, true>, kBwdGroups,
                       sizeof(__nv_bfloat162), n, num_levels, s, p, static_cast<const __nv_bfloat162*>(g), sc, dt,
                       n, num_levels, log2_t);
  } else {
    err = launch_tiled(hash_encode_bwd_table_kernel<kBwdGroups, false>, kBwdGroups, sizeof(float2), n,
                       num_levels, s, p, static_cast<const float2*>(g), sc, dt, n, num_levels, log2_t);
  }
  return (int)err;
}

extern "C" int hash_encode_bwd_pos(const void* pos, const void* table, const void* g,
                                   const void* scalings, void* dpos, long long n, int num_levels,
                                   int log2_t, int g_bf16, int device, void* stream) {
  if (bad_shape(n, num_levels, log2_t, 0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float2* t = static_cast<const float2*>(table);
  const float* sc = static_cast<const float*>(scalings);
  float* dp = static_cast<float*>(dpos);
  if (g_bf16) {
    hash_encode_bwd_pos_kernel<true><<<blocks(n), kThreads, 0, s>>>(
        p, t, static_cast<const __nv_bfloat162*>(g), sc, dp, n, num_levels, log2_t);
  } else {
    hash_encode_bwd_pos_kernel<false><<<blocks(n), kThreads, 0, s>>>(
        p, t, static_cast<const float2*>(g), sc, dp, n, num_levels, log2_t);
  }
  return (int)cudaGetLastError();
}
