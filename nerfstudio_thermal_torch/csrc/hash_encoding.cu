// Multiresolution hash-grid encoding for Hopper (sm_90a): forward, table
// gradient, position gradient and the position gradient's VJP, bound to
// Python through a plain C interface (ctypes). Wrappers, autograd nodes and
// the launch checks live in nerfstudio_thermal_torch/ops/cuda/
// hash_encoding.py; the plain PyTorch versions of the same four functions
// in nerfstudio_thermal_torch/ops/encodings.py.
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
// - hash_encode_bwd_pos_vjp (no TPU kernel: JAX differentiates the jnp
//   backward of hash_encode's custom VJP, ops/encodings.py:_hash_encode_bwd):
//   the VJP of d_pos for a cotangent v, giving dg, d_table and d_pos2, the
//   second derivative an SDF's eikonal loss takes through the grid. See
//   the comment above its kernel.
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
// Position gradient (8 or more levels, the base field's 16): the same
// tile mapping, G = 8 groups (256 points) a block of 8 warps. g's tile and
// the tile's positions are staged in shared memory (an item then waits on
// device memory once, for its rows; with the positions loaded per item it
// waited twice). Each item writes its point's term of its level,
// scaling_l * d_off (the three dimensions), into a shared [phase levels][3]
// [256] buffer; the levels go 4 at a time, and after each phase one thread
// per point adds the phase's terms in level order to its running sums in
// registers, so the levels are summed in order 0..L-1, as the first design
// sums them, with no atomics: two runs give the same bits. Fewer than
// 8 levels (the proposals' 5) walk them one thread per point (the first
// design), which was faster there: a tile of 5 levels pays its staging and
// barriers for little work.
//
// Sizing, on the model's points (H100 80GB HBM3, 700 W; the 8 calls of a
// thermal-nerfacto training step, ms per step; each shape a build of this
// file with its constants changed, timed on the recorded calls by
// chip_smoke.py's hash_model_phase, every shape's d_pos bitwise equal; the
// first design, walking every call, read 1.095-1.106 in other calls):
// - the final shape, G = 8, 8 warps, phases of 4 levels, one item at a
//   time: 0.912-0.919 (16-level calls 0.164-0.166 each, against 0.209-0.213
//   walked; the 5-level calls walked, 0.085 / 0.041). Phases of 2 levels
//   0.935, 1 0.941, 8 1.113, 16 (all levels at once: 49 KB of terms a
//   block) 2.096; G = 16 with 16 warps 0.930, G = 8 with 16 warps 1.005, G
//   = 4 with 4 warps 0.976 (4 with 8: 1.059), G = 2 with 4 warps 1.039;
//   two or four items' gathers before their terms (73 / 127 registers)
//   0.935 / 0.980.
// - Tried on the way, every call tiled: all levels in one phase with the
//   positions read per item, G = 8 and 16 warps (84 KB of shared memory a
//   block, 2 blocks an SM) 2.46 (16-level calls 0.53); G = 4 1.34, G = 2
//   1.40, G = 1 1.54; with the positions staged G = 4 1.18; phases of 4
//   levels with G = 8 and 8 warps 1.06, where the 5-level calls took
//   0.137 / 0.064 against 0.084 / 0.042 walked. Without the __syncwarp
//   between an item's gathers and their use, 0.21 per 16-level call
//   instead of 0.165 (a step 1.097-1.106, as slow as the walk): in the
//   SASS (cuobjdump) ptxas issues each of the 8 gathers just before its
//   use, so their latencies add up; with the fence the 8 go out together.
//
// Numerics: products and sums use __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc cannot contract them into FMAs: the forward and the position
// gradient round exactly as the plain versions' separate multiplies and
// adds (the forward's corners are summed in order 0..7 as before; the
// position gradient's levels in order, where the plain version sums them
// in its own order, so the two agree to f32 rounding of that sum). The
// table gradient sums a group's terms in a shuffle tree and its atomics in
// an order that changes from run to run, so its sums agree with the plain
// version's only to f32 rounding of a reordered sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// The tiles of the forward, the table gradient and the position gradient:
// G groups of 32 consecutive points, one point per lane; a block of at most
// kMaxWarps warps (the position gradient: kPosWarps) takes the tile's G * L
// (group, level) items in turn, item = level * G + group, warp w the items
// w, w + warps, ..., with as many warps as spread the items evenly
// (tile_warps). The position gradient's tile takes its levels kPosPhase at
// a time. Its shape is the fastest of those the header lists.
constexpr int kFwdGroups = 8, kBwdGroups = 1, kPosGroups = 8;
constexpr int kMaxWarps = 16, kPosWarps = 8, kPosPhase = 4;
static_assert(kPosWarps * 32 >= kPosGroups * 32, "the position gradient's sums take one point a thread");
// The position gradient of fewer levels than this walks them one thread per
// point (see the header).
constexpr int kPosTiledLevels = 8;
constexpr int kWalkThreads = 256;
constexpr size_t kSmemLimit = 232448;  // shared memory one block may use
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
// at most max_warps warps, then the fewest warps that take them all.
__host__ __forceinline__ int tile_warps(int groups, int num_levels, int max_warps) {
  const int items = groups * num_levels;
  const int per_warp = (items + max_warps - 1) / max_warps;
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

// One point's term of one level of the position gradient: d_off *
// scaling per dimension, d_off summed over the corners in order 0..7,
// every product and sum rounded as the plain version rounds them.
__device__ __forceinline__ void pos_terms(float2 gv, const Corners& k, const float2 v[8], float scaling,
                                          float t[3]) {
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
  for (int d = 0; d < 3; ++d) t[d] = __fmul_rn(d_off[d], scaling);
}

// d_pos[n, d] on the tile mapping: block b owns the kGroups * 32 points
// from b * that; a warp's item is one level of 32 of them, lane = point;
// g's tile and the tile's positions come through shared memory, so an
// item waits on global memory once, for its rows. The levels go kPosPhase
// at a time: each item writes its point's terms into a shared [phase
// levels][3][32 G] f32 buffer (lane = point: no bank conflict), then one
// thread per point adds the phase's levels in order to its sums, which it
// keeps in registers; after the last phase it writes d_pos. The levels are
// summed in order 0..L-1, with no atomics.
template <bool kBf16G>
__global__ void __launch_bounds__(32 * kMaxWarps)
    hash_encode_bwd_pos_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                               const typename PairOf<kBf16G>::T* __restrict__ g, const float* __restrict__ scalings,
                               float* __restrict__ dpos, long long n_points, int num_levels, int log2_t) {
  using Pair = typename PairOf<kBf16G>::T;
  constexpr int kPoints = 32 * kPosGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  Pair* tile = reinterpret_cast<Pair*>(smem);
  float* terms = reinterpret_cast<float*>(smem + tile_bytes(kPosGroups, num_levels, sizeof(Pair)));
  const int phase = min(kPosPhase, num_levels);
  float* pos_s = terms + kPoints * phase * 3;
  const long long n0 = (long long)blockIdx.x * kPoints;
  const int rows = (int)min((long long)kPoints, n_points - n0);
  copy_tile_in(tile, g + n0 * num_levels, rows, num_levels);
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x) pos_s[i] = __ldg(pos + 3 * n0 + i);
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warps = blockDim.x >> 5;
  const int stride = tile_stride(num_levels);
  const uint32_t mask = (1u << log2_t) - 1u;
  float acc[3] = {0.f, 0.f, 0.f};  // thread i's point i (blockDim.x >= kPoints)
  for (int l0 = 0; l0 < num_levels; l0 += phase) {
    const int levels = min(phase, num_levels - l0);
    for (int item = tid >> 5; item < kPosGroups * levels; item += warps) {
      const int l = l0 + item / kPosGroups, r = (item % kPosGroups) * 32 + lane;
      Corners k;
      float2 v[8];
      if (r < rows) {
        const float p[3] = {pos_s[3 * r], pos_s[3 * r + 1], pos_s[3 * r + 2]};
        corner_factors(p, __ldg(scalings + l), k);
        gather_level(table + ((size_t)l << log2_t), k, mask, v);
      }
      // all 8 gathers are issued before any is used: without this fence
      // the compiler uses each row right after its load, the loads wait
      // one after another, and a 16-level call takes 0.21 ms, not 0.165
      __syncwarp();
      if (r >= rows) continue;
      float t[3];
      pos_terms(from_pair<kBf16G>(tile[r * stride + l]), k, v, __ldg(scalings + l), t);
#pragma unroll
      for (int d = 0; d < 3; ++d) terms[((l - l0) * 3 + d) * kPoints + r] = t[d];
    }
    __syncthreads();
    if (tid < rows) {
      for (int lv = 0; lv < levels; ++lv) {
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d] = __fadd_rn(acc[d], terms[(lv * 3 + d) * kPoints + tid]);
      }
    }
    __syncthreads();  // the next phase overwrites the terms
  }
  if (tid < rows) {
#pragma unroll
    for (int d = 0; d < 3; ++d) dpos[3 * (n0 + tid) + d] = acc[d];
  }
}

// d_pos[n, d], one thread per point walking its levels (the first design,
// kept for few levels: see the header), summing them in order 0..L-1.
template <bool kBf16G>
__global__ void __launch_bounds__(kWalkThreads)
    hash_encode_bwd_pos_walk_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                                    const typename PairOf<kBf16G>::T* __restrict__ g,
                                    const float* __restrict__ scalings, float* __restrict__ dpos, long long n_points,
                                    int num_levels, int log2_t) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  float p[3];
  load_point(pos, n, p);
  const uint32_t mask = (1u << log2_t) - 1u;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < num_levels; ++l) {
    const float scaling = __ldg(scalings + l);
    Corners k;
    corner_factors(p, scaling, k);
    float2 v[8];
    gather_level(table + ((size_t)l << log2_t), k, mask, v);
    float t[3];
    pos_terms(from_pair<kBf16G>(g[n * num_levels + l]), k, v, scaling, t);
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] = __fadd_rn(acc[d], t[d]);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) dpos[3 * n + d] = acc[d];
}

// The tiled position gradient's shared memory: the staged g tile, the
// [phase levels][3][32 G] f32 terms, then the tile's [32 G, 3] positions.
size_t pos_smem(int num_levels, size_t pair_bytes) {
  return tile_bytes(kPosGroups, num_levels, pair_bytes) +
         (size_t)32 * kPosGroups * (std::min(kPosPhase, num_levels) + 1) * 3 * sizeof(float);
}

bool bad_shape(long long n, int num_levels, int log2_t, size_t smem) {
  return n <= 0 || num_levels <= 0 || log2_t < 0 || log2_t > 30 || smem > kSmemLimit;
}

// One launch of a tiled kernel of `groups` * 32 points a block and at most
// max_warps warps, with smem bytes of dynamic shared memory (allowed above
// 48 KB where a large L needs it).
template <typename... Params, typename... Args>
cudaError_t launch_tiled(void (*kernel)(Params...), int groups, int max_warps, size_t smem, long long n,
                         int num_levels, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long points = 32LL * groups;
  kernel<<<(unsigned int)((n + points - 1) / points), 32 * tile_warps(groups, num_levels, max_warps), smem, s>>>(
      args...);
  return cudaGetLastError();
}

// The position gradient: the tile mapping from kPosTiledLevels levels on
// (while its shared memory fits: L <= 105 with an f32 g), else the walk.
template <bool kBf16G>
cudaError_t launch_bwd_pos(const float* p, const float2* t, const typename PairOf<kBf16G>::T* g, const float* sc,
                           float* dp, long long n, int num_levels, int log2_t, cudaStream_t s) {
  const size_t smem = pos_smem(num_levels, sizeof(typename PairOf<kBf16G>::T));
  if (num_levels >= kPosTiledLevels && smem <= kSmemLimit)
    return launch_tiled(hash_encode_bwd_pos_kernel<kBf16G>, kPosGroups, kPosWarps, smem, n, num_levels, s, p,
                        t, g, sc, dp, n, num_levels, log2_t);
  hash_encode_bwd_pos_walk_kernel<kBf16G><<<(unsigned int)((n + kWalkThreads - 1) / kWalkThreads), kWalkThreads, 0,
                                            s>>>(p, t, g, sc, dp, n, num_levels, log2_t);
  return cudaGetLastError();
}


// The position gradient's VJP: for the cotangent v [N, 3] of d_pos, per
// point n, level l (scaling s) and corner c (its row r_c, trilinear factors
// w_{c,d}, sg_{c,d} = +1 on a ceil bit and -1 on a floor bit):
//   a_c = s * sum_d v_d sg_{c,d} prod_{e != d} w_{c,e}
//   dg[n, 2l + f] = sum_c a_c r_c[f]                      (in corner order)
//   d_table[r_c, f] += g[n, 2l + f] a_c                   (atomics)
//   d_pos2[n, k] += s^2 sum_c (g . r_c) sg_{c,k} sum_{d != k} v_d sg_{c,d}
//                   prod_{e not in {d, k}} w_{c,e}        (levels in order)
// each rounded as hash_encode_bwd_pos_vjp_plain rounds it (no FMA
// contraction). dg only reads the rows, d_table only g, d_pos2 both.
//
// What bounds it: d_table's REDs. On neus-facto's SDF-grid call (98,304
// points, L 16, T 2^19; H100 80GB HBM3, 700 W) the kernel must move 0.036
// ms of bytes, but the 12.6M corner contributions make 10.1M float2 REDs
// after row 7's warp combine, and d_table alone takes ~0.17 ms (as row 7's
// scatter of the same call). The step needs dg and d_table (its backward
// differentiates the parameters only, so d_pos2 is not asked for).
//
// Design:
// - One body for every output set: a null output pointer skips its work at
//   run time, and a set without dg or d_pos2 gathers no rows. (A template
//   with one instance per set was no faster on the step's set and slower
//   alone: below.)
// - Row 10's tile: a block owns kVjpGroups groups of 32 consecutive points
//   (their positions and v staged in shared memory), its warps take the
//   tile's (group, level) items in turn, item = level * G + group, lane =
//   point. g's [32 G, 2L] tile is read into shared memory 16 bytes a
//   thread (copy_tile_in), and each item writes its dg pair in place of
//   its g pair, so dg leaves the same tile 16 bytes a thread
//   (copy_tile_out): device memory sees both contiguous.
// - The levels go kVjpPhase at a time, with a block barrier after each
//   phase, so a block's warps work on the same levels (their rows meet in
//   L1 and their REDs on the same table slices in L2; without the barriers
//   the step's set, whose items are otherwise independent, is slower:
//   below). With d_pos2, each item writes its point's terms of its level
//   into a shared [phase][3][32 G] buffer that one thread per point adds in
//   level order after the phase (row 10's scheme), so d_pos2 sums the
//   levels 0..L-1 in order, with no atomics: two runs give the same bits.
// - d_table: row 7's warp combine (__match_any_sync per corner, sum_peers,
//   one RED per distinct row of the warp), but only at a level where two
//   neighbouring lanes share a cell (their corner-0 rows are equal): a
//   warp's lanes match a row of another lane's same corner only in the same
//   cell, and the model's points are ray-major, so at the fine levels,
//   where no cell repeats, each lane adds its own 8 REDs without matching
//   (on the recorded call ~21,200 of the 49,152 (warp, level) items match).
// - No block-wide combine. Host counts of the recorded call's REDs
//   (train_timing.py --vjp): 12.58M uncombined, 10.12M warp-combined per
//   corner, 8.29M over a 256-point tile: levels 0-3 fall 2.2-3.3x from
//   warp to tile, the fine half (levels 8-15, 6.3M REDs) not at all.
//   Tried: a shared-memory table of a level's rows (open addressing, at
//   most 8 probes, else a RED; flushed with one RED per row after each
//   level, only by warps whose lanes share cells): slower at every shape
//   and size (below).
//
// Sizing (train_timing.py --vjp on neus-facto's step-9 call, H100 80GB
// HBM3, 700 W; raw launches, ms for dg + d_table / all three; every build
// dg bitwise and within VJP_TOLS of the plain version; ranges over the
// runs that timed a build):
// - The first design (one body, G = 8 with 8 warps, g and dg a pair a lane,
//   phases of 4 levels, d_table's match at every level): 0.2867-0.2980 /
//   0.2902-0.3002.
// - The final shape, G = 8, 8 warps (16 items a warp; 384 blocks, one
//   wave at 3 blocks an SM), phases of 2 levels, one item at a time, the
//   match only where lanes share cells: 0.2174-0.2215 / 0.2207-0.2228;
//   alone dg 0.0594-0.0598, d_table 0.1645-0.1652, d_pos2 0.0647-0.0649.
//   78 registers (ptxas); shared memory 40 KB for dg + d_table, 46 KB with
//   d_pos2.
// - The same shape as a template, one instance per output set (46-74
//   registers, dg + d_table 58: 4 blocks an SM), in the same call:
//   0.2205-0.2208 / 0.2214-0.2224; alone dg 0.1246-0.1254, d_pos2
//   0.0705-0.0707. The rest of this list was timed on the template.
// - Barriers in the step's set (G = 8, 8 warps; d_pos2's phases of 4): a
//   barrier every level 0.2199-0.2211, 2 levels 0.2174-0.2207, 4
//   0.2180-0.2240, 8 0.2193-0.2257, none 0.2261-0.2300. d_pos2's phases
//   (all three): 1 level 0.2215-0.2232, 2 0.2185-0.2209, 4 0.2192-0.2249,
//   8 0.2240-0.2282; d_pos2 alone 0.071 at 2 levels, 0.121 at 4.
// - Other tiles (no barrier in the step's set, d_pos2 in phases of 4): G =
//   8 with 16 warps 0.2530-0.2534 / 0.2436-0.2446 (two waves at 2 blocks
//   an SM; with barriers every 4 / 2 levels 0.2444-0.2450 / 0.2453-0.2459),
//   G = 4 with 4 warps 0.2298-0.2299 / 0.2222-0.2250 (barriers every 4
//   levels 0.2208-0.2219 / 0.2202-0.2208), 8 warps 0.2539-0.2540 /
//   0.2416-0.2429, 16 warps 0.2392-0.2398 / 0.2510-0.2515; G = 2 with 2
//   warps 0.2316-0.2321 / 0.2249-0.2250, 4 warps 0.2494-0.2497 /
//   0.2429-0.2430, 8 warps 0.2384-0.2386 / 0.2436-0.2447; G = 1 with 4
//   warps 0.2415-0.2419 / 0.2426; G = 16 with 16 warps 0.2575-0.2588 /
//   0.2409-0.2420.
// - Two items' gathers in flight before their use (89-115 registers): G =
//   8 with 8 / 16 warps 0.2472-0.2479 / 0.2434-0.2439 and 0.2419-0.2420 /
//   0.2425; G = 4 with 4 / 8 warps 0.2481-0.2489 / 0.2470-0.2479 and
//   0.2423-0.2425 / 0.2442-0.2444.
// - The match (G = 8, 16 warps): at every level 0.2571 / 0.2455-0.2466
//   (d_table alone 0.1762-0.1763 against 0.1564-0.1638), never
//   0.3473-0.3487 / 0.3694-0.3697 (d_table alone 0.2427-0.2430): a
//   coarse level's uncombined REDs serialise on their few rows.
// - The shared-memory combine: G = 8, 8 warps, 2^11 rows 0.2524-0.2528 /
//   0.3142-0.3145, 2^10 0.2907-0.2937 / 0.2584-0.2635, 2^12 0.3287-0.3295
//   / 0.4226-0.4227, used at every level 0.2579-0.2590 / 0.4287-0.4290; G =
//   4, 4 warps, 2^10 0.2963-0.2969 / 0.3297-0.3315; G = 8, 16 warps
//   0.2910-0.2912 / 0.3598-0.3602; G = 16, 16 warps, 2^12 0.3049-0.3054 /
//   0.3208-0.3216. Its probes and per-level barriers cost more than the
//   REDs they save.
// - What the step's set still pays: d_table alone takes 0.163-0.168 (as
//   row 7's scatter of the same call) and dg alone ~0.06; the pair ~0.22,
//   so the gathers hide only in part under the REDs.
constexpr int kVjpGroups = 8, kVjpWarps = 8, kVjpPhase = 2;
static_assert(kVjpWarps >= kVjpGroups, "d_pos2's sums take one point a thread");

// d_table[row_c] += g * a_c for one item's 8 corners: row 7's warp combine
// where two neighbouring lanes share a cell, else one RED a lane and corner.
// Every lane of the warp calls it; `adds`: this lane contributes.
__device__ __forceinline__ void vjp_table_reds(float2* __restrict__ dl, const Corners& k, const float a[8],
                                               float2 gv, bool adds, uint32_t mask, int lane) {
  if (!__any_sync(kFull, adds)) return;
  const uint32_t row0 = corner_row(k, 0, mask);
  const uint32_t below = __shfl_up_sync(kFull, adds ? row0 : kNoRow, 1);
  const bool combine = __any_sync(kFull, adds && lane > 0 && below == row0);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t row = corner_row(k, c, mask);
    float2 sum = make_float2(__fmul_rn(gv.x, a[c]), __fmul_rn(gv.y, a[c]));
    bool lead = adds;
    if (combine) {
      uint32_t peers = __match_any_sync(kFull, adds ? row : kNoRow);
      if (!adds) peers = 1u << lane;  // alone: no shuffle rounds for the lanes that add nothing
      sum = sum_peers(peers, lane, sum);
      lead = adds && lane == __ffs(peers) - 1;
    }
    if (lead) atomicAdd(dl + row, sum);
  }
}

// The VJP on the tile mapping (see above): block b owns the kVjpGroups * 32
// points from b * that; a null dg / dtable / dpos2 skips that output.
__global__ void __launch_bounds__(32 * kVjpWarps)
    hash_encode_bwd_pos_vjp_kernel(const float* __restrict__ pos, const float2* __restrict__ table,
                                   const float2* __restrict__ g, const float* __restrict__ v,
                                   const float* __restrict__ scalings, float2* __restrict__ dg,
                                   float2* __restrict__ dtable, float* __restrict__ dpos2, long long n_points,
                                   int num_levels, int log2_t) {
  const bool reads_g = dtable != nullptr || dpos2 != nullptr;
  const bool gathers = dg != nullptr || dpos2 != nullptr;  // the corner rows
  constexpr int kPoints = 32 * kVjpGroups;
  extern __shared__ __align__(16) unsigned char vjp_smem[];
  float2* tile = reinterpret_cast<float2*>(vjp_smem);  // g in, dg out: [kPoints][tile_stride(L)]
  float* pos_s =
      reinterpret_cast<float*>(vjp_smem + ((reads_g || dg) ? tile_bytes(kVjpGroups, num_levels, 8) : 0));
  float* v_s = pos_s + 3 * kPoints;  // [kPoints][3] each
  float* terms = v_s + 3 * kPoints;  // d_pos2: [phase][3][kPoints]
  const long long n0 = (long long)blockIdx.x * kPoints;
  const int rows = (int)min((long long)kPoints, n_points - n0);
  if (reads_g) copy_tile_in(tile, g + n0 * num_levels, rows, num_levels);
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x) {
    pos_s[i] = __ldg(pos + 3 * n0 + i);
    v_s[i] = __ldg(v + 3 * n0 + i);
  }
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warps = blockDim.x >> 5;
  const int stride = tile_stride(num_levels);
  const uint32_t mask = (1u << log2_t) - 1u;
  const int phase = min(kVjpPhase, num_levels);
  float acc[3] = {0.f, 0.f, 0.f};  // d_pos2: thread i's point i
  for (int l0 = 0; l0 < num_levels; l0 += phase) {
    const int levels = min(phase, num_levels - l0);
    for (int item = tid >> 5; item < kVjpGroups * levels; item += warps) {
      const int l = l0 + item / kVjpGroups, r = (item % kVjpGroups) * 32 + lane;
      const bool live = r < rows;
      const float s = __ldg(scalings + l);
      float p[3] = {0.f, 0.f, 0.f}, u[3] = {0.f, 0.f, 0.f};
      if (live) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          p[d] = pos_s[3 * r + d];
          u[d] = v_s[3 * r + d];
        }
      }
      Corners k;
      corner_factors(p, s, k);
      float2 rv[8];
      if (gathers) {
        if (live) gather_level(table + ((size_t)l << log2_t), k, mask, rv);
        __syncwarp();  // the gathers go out together before their use (row 10's fence)
      }
      float a[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wx = (c & 4) ? k.wc[0] : k.wf[0];
        const float wy = (c & 2) ? k.wc[1] : k.wf[1];
        const float wz = (c & 1) ? k.wc[2] : k.wf[2];
        const float ux = (c & 4) ? u[0] : -u[0];
        const float uy = (c & 2) ? u[1] : -u[1];
        const float uz = (c & 1) ? u[2] : -u[2];
        const float sum = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ux, wy), wz), __fmul_rn(__fmul_rn(uy, wx), wz)),
                                    __fmul_rn(__fmul_rn(uz, wx), wy));
        a[c] = __fmul_rn(s, sum);
      }
      float2 gv = make_float2(0.f, 0.f);
      if (reads_g && live) gv = tile[r * stride + l];
      if (dg && live) {
        float o0 = 0.f, o1 = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          o0 = __fadd_rn(o0, __fmul_rn(a[c], rv[c].x));
          o1 = __fadd_rn(o1, __fmul_rn(a[c], rv[c].y));
        }
        tile[r * stride + l] = make_float2(o0, o1);  // in place of g, which this item alone reads
      }
      if (dtable) {
        vjp_table_reds(dtable + ((size_t)l << log2_t), k, a, gv, live && (gv.x != 0.f || gv.y != 0.f), mask, lane);
      }
      if (dpos2 && live) {
        float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float wx = (c & 4) ? k.wc[0] : k.wf[0];
          const float wy = (c & 2) ? k.wc[1] : k.wf[1];
          const float wz = (c & 1) ? k.wc[2] : k.wf[2];
          const float ux = (c & 4) ? u[0] : -u[0];
          const float uy = (c & 2) ? u[1] : -u[1];
          const float uz = (c & 1) ? u[2] : -u[2];
          const float gdf = __fadd_rn(__fmul_rn(gv.x, rv[c].x), __fmul_rn(gv.y, rv[c].y));
          const float gx = (c & 4) ? gdf : -gdf;
          const float gy = (c & 2) ? gdf : -gdf;
          const float gz = (c & 1) ? gdf : -gdf;
          t[0] = __fadd_rn(t[0], __fmul_rn(gx, __fadd_rn(__fmul_rn(uy, wz), __fmul_rn(uz, wy))));
          t[1] = __fadd_rn(t[1], __fmul_rn(gy, __fadd_rn(__fmul_rn(ux, wz), __fmul_rn(uz, wx))));
          t[2] = __fadd_rn(t[2], __fmul_rn(gz, __fadd_rn(__fmul_rn(ux, wy), __fmul_rn(uy, wx))));
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) terms[((l - l0) * 3 + d) * kPoints + r] = __fmul_rn(__fmul_rn(t[d], s), s);
      }
    }
    __syncthreads();  // the block's warps leave a phase together (and d_pos2's terms are in)
    if (dpos2) {
      if (tid < rows) {
        for (int lv = 0; lv < levels; ++lv) {
#pragma unroll
          for (int d = 0; d < 3; ++d) acc[d] = __fadd_rn(acc[d], terms[(lv * 3 + d) * kPoints + tid]);
        }
      }
      __syncthreads();  // the next phase overwrites the terms
    }
  }
  if (dpos2 && tid < rows) {
#pragma unroll
    for (int d = 0; d < 3; ++d) dpos2[3 * (n0 + tid) + d] = acc[d];
  }
  if (dg) copy_tile_out(tile, dg + n0 * num_levels, rows, num_levels);
}

// The VJP's shared memory: the g / dg tile (when it reads g or forms dg),
// the tile's positions and v, and d_pos2's terms of one phase.
size_t vjp_smem_bytes(int num_levels, bool with_g, bool with_dg, bool with_pos) {
  return ((with_g || with_dg) ? tile_bytes(kVjpGroups, num_levels, sizeof(float2)) : 0) +
         (size_t)32 * kVjpGroups * (6 + (with_pos ? 3 * std::min(kVjpPhase, num_levels) : 0)) * sizeof(float);
}

}  // namespace

// Each function returns the cudaError_t of its launch (0 on success). The
// pointers are device pointers: pos [n, 3] f32, table and d_table
// [L * 2^log2_t, 2] f32, scalings [L] f32, out and g [n, 2L] in bf16 (flag
// 1) or f32 (flag 0), d_pos [n, 3] f32; out and g 16-byte aligned (the
// tiles move 16 bytes at a time). d_table must be zeroed by the caller;
// the other outputs are written in full.
extern "C" int hash_encode_fwd(const void* pos, const void* table, const void* scalings,
                               void* out, long long n, int num_levels, int log2_t,
                               int out_bf16, int device, void* stream) {
  const size_t pair = out_bf16 ? sizeof(__nv_bfloat162) : sizeof(float2);
  const size_t smem = tile_bytes(kFwdGroups, num_levels, pair);
  if (bad_shape(n, num_levels, log2_t, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float2* t = static_cast<const float2*>(table);
  const float* sc = static_cast<const float*>(scalings);
  if (out_bf16) {
    err = launch_tiled(hash_encode_fwd_kernel<kFwdGroups, true>, kFwdGroups, kMaxWarps, smem, n, num_levels, s, p,
                       t, sc, static_cast<__nv_bfloat162*>(out), n, num_levels, log2_t);
  } else {
    err = launch_tiled(hash_encode_fwd_kernel<kFwdGroups, false>, kFwdGroups, kMaxWarps, smem, n, num_levels, s, p,
                       t, sc, static_cast<float2*>(out), n, num_levels, log2_t);
  }
  return (int)err;
}

extern "C" int hash_encode_bwd_table(const void* pos, const void* g, const void* scalings,
                                     void* dtable, long long n, int num_levels, int log2_t,
                                     int g_bf16, int device, void* stream) {
  const size_t smem = tile_bytes(kBwdGroups, num_levels, g_bf16 ? sizeof(__nv_bfloat162) : sizeof(float2));
  if (bad_shape(n, num_levels, log2_t, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* sc = static_cast<const float*>(scalings);
  float2* dt = static_cast<float2*>(dtable);
  if (g_bf16) {
    err = launch_tiled(hash_encode_bwd_table_kernel<kBwdGroups, true>, kBwdGroups, kMaxWarps, smem, n, num_levels,
                       s, p, static_cast<const __nv_bfloat162*>(g), sc, dt, n, num_levels, log2_t);
  } else {
    err = launch_tiled(hash_encode_bwd_table_kernel<kBwdGroups, false>, kBwdGroups, kMaxWarps, smem, n, num_levels,
                       s, p, static_cast<const float2*>(g), sc, dt, n, num_levels, log2_t);
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
    err = launch_bwd_pos<true>(p, t, static_cast<const __nv_bfloat162*>(g), sc, dp, n, num_levels, log2_t, s);
  } else {
    err = launch_bwd_pos<false>(p, t, static_cast<const float2*>(g), sc, dp, n, num_levels, log2_t, s);
  }
  return (int)err;
}

// dg [n, 2L] f32, d_table [L * 2^log2_t, 2] f32 (zeroed by the caller) and
// d_pos2 [n, 3] f32 for the cotangent v [n, 3] f32 of d_pos, with g [n, 2L]
// f32; g and dg 16-byte aligned; a null output pointer skips that output.
// The g / dg tile must fit shared memory: up to 103 levels with d_pos2,
// 109 without.
extern "C" int hash_encode_bwd_pos_vjp(const void* pos, const void* table, const void* g, const void* v,
                                       const void* scalings, void* dg, void* dtable, void* dpos2, long long n,
                                       int num_levels, int log2_t, int device, void* stream) {
  const size_t smem = vjp_smem_bytes(num_levels, dtable != nullptr || dpos2 != nullptr, dg != nullptr,
                                     dpos2 != nullptr);
  if (bad_shape(n, num_levels, log2_t, smem)) return (int)cudaErrorInvalidValue;
  if (dg == nullptr && dtable == nullptr && dpos2 == nullptr) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(hash_encode_bwd_pos_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr long long kPoints = 32LL * kVjpGroups;
  hash_encode_bwd_pos_vjp_kernel<<<(unsigned int)((n + kPoints - 1) / kPoints), 32 * kVjpWarps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float2*>(table), static_cast<const float2*>(g),
      static_cast<const float*>(v), static_cast<const float*>(scalings), static_cast<float2*>(dg),
      static_cast<float2*>(dtable), static_cast<float*>(dpos2), n, num_levels, log2_t);
  return (int)cudaGetLastError();
}
