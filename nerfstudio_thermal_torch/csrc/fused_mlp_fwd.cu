// Fused-MLP forward for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes). Wrapper, plain PyTorch version and the weight packing
// live in nerfstudio_thermal_torch/ops/cuda/fused_mlp.py.
//
// Replaces the TPU kernels nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:
// _fwd_kernel (:318, entry point fused_mlp) and, through fused_ray_fwd.cu,
// the MLP part of _ray_fwd_kernel (:774). Function: per point, an optional
// NeRF frequency encoding [sin(x_d * f_k), cos(x_d * f_k), x] computed in
// f32 and rounded to the compute dtype, then relu hidden layers; a skip
// layer takes concat([x0, h]) with x0 the encoded input; the last layer
// applies none or sigmoid. Each layer adds its bias (rounded to the compute
// dtype, then widened to f32) to an f32 accumulator, applies the activation
// in f32 and rounds to the compute dtype. Output in the compute dtype.
//
// What bounds it: the products. The base field of thermal-nerfacto-tpu (8 x
// 256, skip at layer 4, 10 frequencies, 63 -> 16) does about 860k FLOP per
// point, 0.91 ms per 1,048,576 points at the H100's 989 TFLOP/s dense
// bf16, against ~46 bytes a point. A proposal stack (48 -> 64 -> 64 -> 16
// padded) does ~16k FLOP a point: 0.017 ms per million points, so little
// work per point that the schedule, not the tensor cores, sets its time.
//
// launch_fwd runs one of three paths, chosen here from the descriptor and
// the compute dtype (fwd_path; the wrapper asks fused_mlp_fwd_plan which
// one a stack takes, and on the wide path for the plan it packs by):
//
// Narrow path (bf16, no skip layer, every padded width <= 64: the proposal
// stacks, the colour head): fused_mlp_fwd_narrow, one persistent pass. As
// many CTAs as fit (two or more per SM) each copy the packed weights (mma
// B-fragment order) into shared memory once and take 128-point tiles
// blockIdx.x, + gridDim.x, ... A warp owns 16 rows of a tile across every
// column, so all 8 warps work in every layer. The warp computes its rows'
// encoding once per (dimension, frequency), sincosf of the one product
// giving both the sin and the cos column, into a warp-private shared-memory
// tile; ldmatrix gives the first layer's A fragments, and every layer's
// rounded accumulators become the next layer's A fragments in registers:
// activations never go through shared memory, and no block barrier runs
// between layers or tiles.
//
// Wide path (bf16, the 8 x 256 stacks with their skip: row 1, row 3's cross
// density, row 5's base): fused_mlp_fwd_wgmma, one persistent CTA per SM of
// two consumer warpgroups and one producer warpgroup (one of its threads
// issues the copies; setmaxnreg moves registers between whole warpgroups,
// so the producer is a full one). A tile is 128 points, 64
// rows per warpgroup; each layer is wgmma.mma_async m64nNk16 (N = 256, or
// the layer's width rounded up to a power of two, at least 64 for a hidden
// layer and 16 for the output layer) with f32 accumulators in registers. The weights do not fit in
// shared memory (0.86 MB for 8 x 256), so B streams through a ring of
// kWgStages K-slices (64 rows x N, 32 KB) filled by cp.async.bulk copies
// that the producer issues ahead, with full/empty mbarriers; the
// wrapper lays the slices out in wgmma's K-major 128-byte-swizzle order
// (fused_mlp.py _wgmma_index), so one bulk copy per slice and no address
// math in the consumers. Every K loop runs whole slices (x0 is padded with
// zeros to 64-column atoms, hidden layers are at least 64 wide), so a
// slice's four wgmmas issue back to back with no branch between them. A of
// a hidden layer comes from registers: the
// previous layer's accumulators, with bias and relu, rounded into bf16 A
// fragments in place (the accumulator and A layouts agree row for row), so
// activations never leave the registers; this costs 64 registers of A
// beside the 128 of the accumulator, which setmaxnreg gives the consumers
// (232; the producer keeps 40). A of layer 0 and of the skip layer's x0
// columns comes from shared memory: each warpgroup writes its rows'
// encoding once per tile in the same swizzled order and keeps it for the
// skip layer. What this design still gives up: both warpgroups run their
// epilogues at the same time (no ping-pong), each 128-point tile reads
// every weight slice from L2 again (0.86 MB per tile), and the producer
// waits for a slot freed by both warpgroups.
//
// f32 path (f32 compute: exact f32 products, as the TPU's Precision.HIGHEST;
// no TF32, no tensor-core instruction): fused_mlp_fwd_f32, one CTA of 512
// threads per 128 points, on fused_mlp_f32.cuh's register-tiled FMA
// product. What bounds it: the products on the CUDA cores, 2 x 491,520
// FLOP a point for the NeRF stack, 15.4 ms per 1,048,576 points at 67
// TFLOP/s. x0 and the hidden activations sit in shared memory k-major, so
// a thread's 8 points at one k are two float4 loads; each layer's weights
// stream through a two-slot cp.async ring of 16-row K-slices that the whole
// CTA reads (one copy per CTA instead of every thread reading its own from
// L2); a thread keeps its 8 x 8 outputs (8 x 4 or 4 x 4 for narrower
// layers) in registers until the layer's barrier, then writes them over
// the one activation buffer with bias and relu, so 128 points fit (x0 +
// h + ring: 227,072 bytes at the 99-wide input). The last layer stores
// from registers, 16 bytes at a time where the output's rows allow.
// Measured (H100, 700 W; chip_smoke.py): 26.5 ms on the NeRF stack at
// 1,048,576 points (38.8 TFLOP/s; the design it replaced, 64 points a CTA
// with every weight read from L2 by every thread, 250.6 ms).
//
// Each kernel is a template over its x0 fill, the code that says where the
// x0 tile comes from (see "x0 fills" below): here x [n, in_dim] f32
// (XFill); fused_ray_fwd.cu instantiates the kernels with its own fills.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: the top frequency reaches
// ~3217 rad per unit of x, where __sinf/__cosf lose all accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "fused_mlp_common.cuh"
#include "fused_mlp_f32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 256;       // 8 warps, narrow path
constexpr int kNarrowRows = 128;    // points per tile of the narrow path: 8 warps x 16
constexpr int kNarrowWidth = 64;    // widest padded layer the narrow path takes
constexpr int kWgRows = 128;        // points per tile of the wide path: 2 warpgroups x 64
constexpr int kWgThreads = 384;     // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kWgStages = 4;        // weight K-slices in the ring
constexpr int kWgSlot = 64 * 256 * 2;  // bytes of a ring slot: 64 k rows x 256 columns, bf16
constexpr int kWgMaxWidth = 256;    // widest padded layer or input the wide path takes
constexpr int kSmemLimit = 232448;  // shared memory one block may use
constexpr int kDescHeader = 9;
constexpr int kDescPerLayer = 5;

enum FwdPath { kPathF32 = 0, kPathNarrow = 1, kPathWgmma = 2 };

struct LayerDesc {
  int k_pad;  // padded input width (multiple of 16)
  int n_pad;  // padded output width (multiple of 16)
  int skip;   // 1: the input is concat([x0, h])
  int w_off;  // offset of the packed weights (elements)
  int b_off;  // offset of the bias (floats)
};

struct MlpDesc {
  int num_layers;
  int in_dim;         // width of x
  int in_pad;         // padded width of x0
  int enc_dim;        // true width of x0
  int num_freqs;      // 0: no encoding
  int include_input;  // encoding appends x
  int hid_pad;        // padded width of the widest hidden layer
  int out_dim;        // true output width
  int out_sigmoid;
  LayerDesc layers[kMaxLayers];
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ float out_act(float v, int sigmoid) {
  return sigmoid ? 1.f / (1.f + expf(-v)) : v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// x0 fills
//
// A kernel fills the x0 tile of a group of rows at a time (a warp's 16 on
// the narrow path, a warpgroup's 64 on the wide path, a block's 64 on the
// f32 path) through its fill, an object of its template argument Fill:
// - a point fill (Fill::kTile false) gives each row's in_dim input values,
//   which the kernel encodes: the group's threads (tid of nthr >= rows) run
//   prepare<T>(n, row0, rows, tid, nthr, sc), which gives thread tid the
//   group's row tid % rows, and value(sc, row, r, k) is then value k of row
//   `row` < n, the group's row r, for the threads that prepared row r and,
//   after the group's barrier, for all;
// - a tile fill (Fill::kTile true) writes the group's whole x0 tile:
//   tile<T>(n, row0, rows, cols, tid, nthr, sc, put, sync), each value
//   rounded to the compute dtype T, put(r, c, v) storing value v at row r,
//   column c, sync() the group's barrier.
// sc points to Fill::kScratch floats of shared memory a row of the group.

// x [n, in_dim] f32, read where the kernel encodes it.
struct XFill {
  static constexpr bool kTile = false;
  static constexpr int kScratch = 0;
  const float* x;
  int in_dim;
  template <typename T>
  __device__ void prepare(int, int, int, int, int, float*) const {}
  __device__ float value(const float*, int row, int, int k) const { return __ldg(x + (size_t)row * in_dim + k); }
};

// ---------------------------------------------------------------------------
// f32 path (fused_mlp_f32.cuh): one CTA of kF32Threads threads per
// kF32Rows points, every layer's output kept in registers until a barrier
// and then written over the one activation buffer.

// Shared memory of the f32 kernel (bytes): x0 and the hidden activations
// (k-major, in_pad and hid_pad rows of kF32Stride floats) with the spill
// rows of a hidden layer wider than 256, the weight ring and the fill's
// scratch, `scratch` floats a row.
struct F32Smem {
  size_t x0, h, ring, sc, total;
};

__host__ __device__ inline F32Smem f32_smem(const MlpDesc& d, int scratch = 0) {
  F32Smem s;
  s.x0 = 0;
  s.h = s.x0 + (size_t)d.in_pad * kF32Stride * 4;
  s.ring = s.h + (size_t)(d.hid_pad + f32_spill_rows(d.hid_pad)) * kF32Stride * 4;
  s.sc = s.ring + (size_t)kF32Stages * kF32Slot * 4;
  s.total = s.sc + (size_t)kF32Rows * scratch * 4;
  return s;
}

// Whether a stack has a layer wider than one column pass (the forward's
// kWide).
__host__ __device__ inline bool f32_fwd_wide(const MlpDesc& d) {
  for (int li = 0; li < d.num_layers; ++li)
    if (d.layers[li].n_pad > kF32MaxWidth) return true;
  return false;
}

// The f32 kernel's products: the column passes of each layer's weights,
// row-major [k_pad, n_pad], layer by layer (product i is layer i when no
// layer is wider than 256).
template <bool kWide>
struct F32FwdSeq {
  const float* w;
  const MlpDesc* d;
  __device__ int count() const {
    int c = 0;
    for (int li = 0; li < d->num_layers; ++li) c += f32_npasses<kWide>(d->layers[li].n_pad);
    return c;
  }
  __device__ F32Operand operator()(int i) const {
    if (!kWide) {
      const LayerDesc& L = d->layers[i];
      return F32Operand{w + L.w_off, L.n_pad, 0, L.n_pad, L.k_pad};
    }
    for (int li = 0;; ++li) {
      const LayerDesc& L = d->layers[li];
      const int p = f32_passes(L.n_pad);
      if (i < p) {
        const int c0 = f32_pass_col0(L.n_pad, i);
        return F32Operand{w + L.w_off, L.n_pad, c0, f32_pass_cols(L.n_pad, c0), L.k_pad};
      }
      i -= p;
    }
  }
};

// x0 tile, k-major: the encoded (or raw) input of the block's points from a
// point fill, one sincosf per (row, dimension, frequency) for the sin and
// the cos column; zero beyond enc_dim and beyond the last point.
template <typename Fill>
__device__ void fill_x0_f32(float* x0, const Fill& fill, const float* sc, const float* __restrict__ freqs, int row0,
                            int n, const MlpDesc& d) {
  const int F = d.num_freqs, nf = d.in_dim * F;
  for (int i = threadIdx.x; i < kF32Rows * nf; i += blockDim.x) {
    const int r = i % kF32Rows, j = i / kF32Rows, dd = j / F;
    const int row = row0 + r;
    float sv = 0.f, cv = 0.f;
    if (row < n) sincosf(fill.value(sc, row, r, dd) * freqs[j - dd * F], &sv, &cv);  // one product
    x0[j * kF32Stride + r] = sv;
    x0[(nf + j) * kF32Stride + r] = cv;
  }
  for (int i = threadIdx.x; i < kF32Rows * (d.in_pad - 2 * nf); i += blockDim.x) {
    const int r = i % kF32Rows, c = 2 * nf + i / kF32Rows;
    const int row = row0 + r;
    x0[c * kF32Stride + r] = row < n && c < d.enc_dim ? fill.value(sc, row, r, c - 2 * nf) : 0.f;
  }
}

// One column pass (columns [c0, c0 + nc)) of a layer: the product of
// [x0 | h] (x0 for layer 0 and skip layers) with the layer's weights, then
// bias and relu into h in place (a pass past column 256 of a layer that
// reads h into the spill rows, copied into h after the layer's last pass),
// or for the last layer bias, output activation and the store of the
// block's rows (16 bytes at a time where the output's rows allow).
template <bool kWide, int TM, int TN>
__device__ __forceinline__ void f32_fwd_layer(const F32Tile<TM, TN>& t, float* x0, float* h,
                                              F32Stream<F32FwdSeq<kWide>>& st, const float* __restrict__ bias,
                                              float* __restrict__ out, int out_stride, int row0, int n, int li, int c0,
                                              int nc, const MlpDesc& d) {
  const LayerDesc& L = d.layers[li];
  const bool last = li == d.num_layers - 1;
  const int k0 = (li == 0 || L.skip) ? d.in_pad : 0;
  float acc[TM][TN];
  f32_product(t, x0, k0, h, L.k_pad, nc, st, acc);
  float b[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) b[j] = t.col(j) < nc ? __ldg(bias + L.b_off + c0 + t.col(j)) : 0.f;
  if (!last) {
    const bool reads_h = k0 < L.k_pad;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (t.col(j) >= nc) continue;
      const int r = f32_out_row(t.col(j), c0, kWide && reads_h && c0 > 0, d.hid_pad);
#pragma unroll
      for (int i = 0; i < TM; i += 4)
        store_points4(h, r, t.point(i), fmaxf(acc[i][j] + b[j], 0.f), fmaxf(acc[i + 1][j] + b[j], 0.f),
                      fmaxf(acc[i + 2][j] + b[j], 0.f), fmaxf(acc[i + 3][j] + b[j], 0.f));
    }
    if (kWide && reads_h && c0 == 0) f32_copy_spill(h, d.hid_pad, L.n_pad);
    return;
  }
  const bool vec = ((out_stride | d.out_dim) & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + t.point(i);
    if (row >= n) continue;
    float* o = out + (size_t)row * out_stride;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int c = c0 + t.col(j);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = out_act(acc[i][j + e] + b[j + e], d.out_sigmoid);
      if (vec && c < d.out_dim) {
        *reinterpret_cast<float4*>(o + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d.out_dim) o[c + e] = v[e];
      }
    }
  }
}

template <typename Fill, bool kWide>
__global__ void __launch_bounds__(kF32Threads, 1)
fused_mlp_fwd_f32(const Fill fill, const float* __restrict__ w, const float* __restrict__ bias,
                  const float* __restrict__ freqs, float* __restrict__ out, int out_stride, int n,
                  const __grid_constant__ MlpDesc d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Smem s = f32_smem(d, Fill::kScratch);
  float* x0 = reinterpret_cast<float*>(smem + s.x0);
  float* h = reinterpret_cast<float*>(smem + s.h);
  float* sc = reinterpret_cast<float*>(smem + s.sc);  // the fill's scratch
  const int row0 = blockIdx.x * kF32Rows;
  const F32FwdSeq<kWide> seq{w, &d};
  F32Stream<F32FwdSeq<kWide>> st;
  st.init(seq, reinterpret_cast<float*>(smem + s.ring), seq.count());
  st.issue();  // the first slice loads while the fill runs
  if constexpr (Fill::kTile) {
    fill.template tile<float>(n, row0, kF32Rows, d.in_pad, threadIdx.x, blockDim.x, sc,
                              [&](int r, int c, float v) { x0[c * kF32Stride + r] = v; }, [] { __syncthreads(); });
  } else {
    fill.template prepare<float>(n, row0, kF32Rows, threadIdx.x, blockDim.x, sc);
    if constexpr (Fill::kScratch > 0) __syncthreads();
    fill_x0_f32(x0, fill, sc, freqs, row0, n, d);
  }
  // (the first product's slice wait is the barrier after the fill)
  for (int li = 0; li < d.num_layers; ++li) {
    const int np = d.layers[li].n_pad;
    for (int q = 0; q < f32_npasses<kWide>(np); ++q) {
      const int c0 = f32_col0<kWide>(np, q), nc = f32_cols<kWide>(np, c0);
      with_f32_tile(nc, [&](auto t) { f32_fwd_layer<kWide>(t, x0, h, st, bias, out, out_stride, row0, n, li, c0, nc, d); });
    }
  }
}

// ---------------------------------------------------------------------------
// Narrow path: one persistent pass, bf16, for a stack with no skip layer and
// every padded width <= kNarrowWidth.

// Shared memory of the narrow kernel (bytes): the packed weights, the
// biases, the tile's x0 rows (each warp writes and reads only its own 16)
// and each warp's fill scratch, `scratch` floats a row.
struct NarrowSmem {
  int x0_stride, total_w, total_b;
  size_t w, bias, x0, sc, total;
};

__host__ __device__ inline NarrowSmem narrow_smem(const MlpDesc& d, int scratch = 0) {
  NarrowSmem s;
  s.total_w = s.total_b = 0;
  for (int i = 0; i < d.num_layers; ++i) {
    s.total_w += d.layers[i].k_pad * d.layers[i].n_pad;
    s.total_b += d.layers[i].n_pad;
  }
  s.x0_stride = d.in_pad + 8;
  s.w = 0;
  s.bias = align16((size_t)s.total_w * 2);
  s.x0 = s.bias + align16((size_t)s.total_b * 4);
  s.sc = s.x0 + align16((size_t)kNarrowRows * s.x0_stride * 2);
  s.total = s.sc + (size_t)kNarrowRows * scratch * 4;
  return s;
}

bool narrow_ok(const MlpDesc& d) {
  if (d.in_pad > kNarrowWidth) return false;
  for (int i = 0; i < d.num_layers; ++i) {
    const LayerDesc& L = d.layers[i];
    if (L.skip || L.k_pad > kNarrowWidth || L.n_pad > kNarrowWidth) return false;
  }
  return narrow_smem(d).total <= (size_t)kSmemLimit;
}

// Each CTA walks tiles blockIdx.x, + gridDim.x, ... of kNarrowRows points;
// warp w owns rows 16 w .. 16 w + 15 of a tile in every layer.
template <typename Fill>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fwd_narrow(const Fill fill, const uint4* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ freqs, __nv_bfloat16* __restrict__ out, int out_stride, int n,
                     MlpDesc d, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NarrowSmem s = narrow_smem(d, Fill::kScratch);
  uint4* w_s = reinterpret_cast<uint4*>(smem + s.w);
  float* b_s = reinterpret_cast<float*>(smem + s.bias);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem + s.x0) + warp * 16 * s.x0_stride;
  float* sc = reinterpret_cast<float*>(smem + s.sc) + warp * 16 * Fill::kScratch;
  const int L = d.num_layers;
  const int F = d.num_freqs, D = d.in_dim, nf = D * F;

  for (int i = threadIdx.x; i < s.total_w / 8; i += blockDim.x) w_s[i] = __ldg(w + i);
  for (int i = threadIdx.x; i < s.total_b; i += blockDim.x) b_s[i] = bias[i];
  __syncthreads();

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kNarrowRows + warp * 16;  // this warp's first row
    if constexpr (Fill::kTile) {
      fill.template tile<__nv_bfloat16>(
          n, row0, 16, d.in_pad, lane, 32, sc,
          [&](int r, int c, float v) { xw[r * s.x0_stride + c] = __float2bfloat16_rn(v); }, [] { __syncwarp(); });
    } else {
      fill.template prepare<__nv_bfloat16>(n, row0, 16, lane, 32, sc);
      if constexpr (Fill::kScratch > 0) __syncwarp();
      // encoding of the warp's 16 rows: one sincosf per (row, dimension,
      // frequency) for the sin and the cos column; raw and padding columns
      for (int j = lane; j < nf; j += 32) {
        const int dd = j / F;
        const float f = freqs[j - dd * F];
        for (int r = 0; r < 16; ++r) {
          const int row = row0 + r;
          float sv = 0.f, cv = 0.f;
          if (row < n) sincosf(fill.value(sc, row, r, dd) * f, &sv, &cv);  // one product
          xw[r * s.x0_stride + j] = __float2bfloat16_rn(sv);
          xw[r * s.x0_stride + nf + j] = __float2bfloat16_rn(cv);
        }
      }
      for (int c = 2 * nf + lane; c < d.in_pad; c += 32) {
        for (int r = 0; r < 16; ++r) {
          const int row = row0 + r;
          const float v = row < n && c < d.enc_dim ? fill.value(sc, row, r, c - 2 * nf) : 0.f;
          xw[r * s.x0_stride + c] = __float2bfloat16_rn(v);
        }
      }
    }
    __syncwarp();
    uint32_t a[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
      if (kt < d.in_pad / 16) ldsm_x4(a[kt], xw + (lane & 15) * s.x0_stride + kt * 16 + (lane >> 4) * 8);
    __syncwarp();  // the next tile's encoding overwrites xw

    float acc[8][4];
    for (int li = 0; li < L; ++li) {
      const LayerDesc Ld = d.layers[li];
      const bool last = li == L - 1;
      warp_product(a, Ld.k_pad / 16, w_s + Ld.w_off / 8, Ld.n_pad / 16, acc);
      const int nt_n = Ld.n_pad / 8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nt_n) {
          const int c = nt * 8 + 2 * q;
          const float b0 = b_s[Ld.b_off + c], b1 = b_s[Ld.b_off + c + 1];
          const float v0 = acc[nt][0] + b0, v1 = acc[nt][1] + b1;
          const float v2 = acc[nt][2] + b0, v3 = acc[nt][3] + b1;
          if (!last) {
            // rows g and g + 8, columns c, c + 1: the A fragment of k-tile nt / 2
            a[nt >> 1][(nt & 1) * 2] = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
            a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(fmaxf(v2, 0.f), fmaxf(v3, 0.f));
          } else {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = row0 + gq + 8 * half;
              if (row < n) {
                __nv_bfloat16* o = out + (size_t)row * out_stride;
                if (c < d.out_dim) o[c] = __float2bfloat16_rn(out_act(half ? v2 : v0, d.out_sigmoid));
                if (c + 1 < d.out_dim) o[c + 1] = __float2bfloat16_rn(out_act(half ? v3 : v1, d.out_sigmoid));
              }
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Wide path: wgmma with a producer warp streaming weight K-slices.

// Per layer: the wgmma width, the K-slices of A read from x0 in shared
// memory (layer 0 and skip layers) and from registers (the previous
// layer's output), and the offset of the layer's slices in the wgmma-order
// weights (elements). Slices hold 64 k rows x nw columns: first those of
// the x0 rows, then those of the h rows. fused_mlp_fwd_plan hands the plan
// to the wrapper, which lays the weights out by it (fused_mlp.py
// _pack_wgmma).
struct WgLayer {
  int nw, slices_x0, slices_h, off;
};

struct WgPlan {
  int tiles, x0_atoms;  // x0_atoms: 64-column swizzle atoms of x0
  WgLayer layers[kMaxLayers];
};

// The wgmma width of a layer: its padded width rounded up to a power of
// two, at least 64 for a hidden layer (so that the next layer's A is whole
// K-slices) and 16 for the output layer.
__host__ __device__ inline int wg_width(int n_pad, bool hidden) {
  int w = hidden ? 64 : 16;
  while (w < n_pad) w *= 2;
  return w;
}

// The plan of a stack the wide path takes, false if it takes none; elems
// is the length of the wgmma-order weights.
bool make_wg_plan(const MlpDesc& d, long long& elems, WgPlan& p) {
  if (d.in_pad > kWgMaxWidth) return false;
  long long off = 0;
  for (int i = 0; i < d.num_layers; ++i) {
    const LayerDesc& L = d.layers[i];
    if (L.n_pad > kWgMaxWidth) return false;
    WgLayer& W = p.layers[i];
    W.nw = wg_width(L.n_pad, i + 1 < d.num_layers);
    W.slices_x0 = (i == 0 || L.skip) ? cdiv(d.in_pad, 64) : 0;
    W.slices_h = i == 0 ? 0 : p.layers[i - 1].nw / 64;
    W.off = (int)off;
    off += (long long)(W.slices_x0 + W.slices_h) * 64 * W.nw;
  }
  p.x0_atoms = cdiv(d.in_pad, 64);
  elems = off;
  return off < (1ll << 31);
}

// Shared memory of the wide kernel: alignment slack, the ring, x0 (per
// atom 128 rows of 128 bytes), the full and empty barriers and the fill's
// scratch, `scratch` floats a row.
size_t wg_smem(const WgPlan& p, int scratch = 0) {
  return 1024 + (size_t)kWgStages * kWgSlot + (size_t)p.x0_atoms * kWgRows * 128 + 2 * kWgStages * 8 +
         (size_t)kWgRows * scratch * 4;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A wait that outlasts ~2^36 cycles (tens of seconds) traps: a broken
// pipeline then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 36)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One bulk copy of `bytes` from global memory into shared memory, counted
// on the barrier's transaction count (set with the producer's arrival).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register accesses across the asynchronous
// wgmma operations that read A and write the accumulators.
__device__ __forceinline__ void fence_regs(float (&acc)[128], uint32_t (&a)[16][4]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Matrix descriptor of a K-major operand in the 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO 64 x 16 bytes); each 16-wide k step starts
// 32 bytes further into the 128-byte rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The consumers' view of the ring: slot and phase of the next slice, and
// the slot whose products may still be running.
struct WgRing {
  uint32_t slots, bars;
  int slot, pending;
  uint32_t phase;

  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kWgStages + s); }
  // waits for the next slice; returns its shared-memory address
  __device__ uint32_t next() {
    mbar_wait(full(slot), phase);
    return slots + slot * kWgSlot;
  }
  __device__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
  }
  // after committing the products of the current slice: the previous
  // slice's products are done, so its slot goes back to the producer
  __device__ void committed() {
    wgmma_wait<1>();
    if (pending >= 0) release(pending);
    pending = slot;
    if (++slot == kWgStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  __device__ void drain() {
    wgmma_wait<0>();
    if (pending >= 0) release(pending);
    pending = -1;
  }
};

// One layer of one warpgroup (64 rows): acc = [x0 | h] W through the ring,
// then the epilogue: for a hidden layer bias, relu and rounding into the
// next layer's A fragments; for the last one bias, output activation and
// the store of rows row and row + 8.
template <int N>
__device__ __forceinline__ void wide_layer(float (&acc)[128], uint32_t (&a)[16][4], const WgLayer& W,
                                           const LayerDesc& L, uint32_t x0_wg, WgRing& ring,
                                           const float* __restrict__ bias, bool last, __nv_bfloat16* out,
                                           int out_stride, int row, int n, const MlpDesc& d) {
  int scale = 0;
  fence_regs(acc, a);
  for (int s = 0; s < W.slices_x0; ++s) {
    const uint32_t slot = ring.next();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<N>::ss(acc, smem_desc(x0_wg + s * kWgRows * 128 + kk * 32), smem_desc(slot + kk * 32),
                   kk > 0 || scale);
    wgmma_commit();
    ring.committed();
    scale = 1;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < W.slices_h) {
      const uint32_t slot = ring.next();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<N>::rs(acc, a[4 * s + kk], smem_desc(slot + kk * 32), kk > 0 || scale);
      wgmma_commit();
      ring.committed();
      scale = 1;
    }
  }
  ring.drain();
  fence_regs(acc, a);

  const int q = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int c = nt * 8 + 2 * q;
    const float b0 = c < L.n_pad ? __ldg(bias + L.b_off + c) : 0.f;
    const float b1 = c < L.n_pad ? __ldg(bias + L.b_off + c + 1) : 0.f;
    const float v0 = acc[4 * nt] + b0, v1 = acc[4 * nt + 1] + b1;
    const float v2 = acc[4 * nt + 2] + b0, v3 = acc[4 * nt + 3] + b1;
    if (!last) {
      a[nt >> 1][(nt & 1) * 2] = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(fmaxf(v2, 0.f), fmaxf(v3, 0.f));
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        if (r < n) {
          __nv_bfloat16* o = out + (size_t)r * out_stride;
          if (c < d.out_dim) o[c] = __float2bfloat16_rn(out_act(half ? v2 : v0, d.out_sigmoid));
          if (c + 1 < d.out_dim) o[c + 1] = __float2bfloat16_rn(out_act(half ? v3 : v1, d.out_sigmoid));
        }
      }
    }
  }
}

template <typename Fill>
__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_fwd_wgmma(const Fill fill, const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                    const float* __restrict__ freqs, __nv_bfloat16* __restrict__ out, int out_stride, int n,
                    MlpDesc d, WgPlan p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle needs 1024-byte aligned atoms
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t x0_off = kWgStages * kWgSlot;
  const uint32_t bars = base + x0_off + p.x0_atoms * kWgRows * 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bars + 8 * s, 1);                // full: the producer's arrival + the bytes
      mbar_init(bars + 8 * (kWgStages + s), 8);  // empty: one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 8) {
    // producer: every slice of every layer of every tile, in the order the
    // consumers read them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int li = 0; li < d.num_layers; ++li) {
          const WgLayer& W = p.layers[li];
          const int slices = W.slices_x0 + W.slices_h;
          for (int s = 0; s < slices; ++s) {
            mbar_wait(bars + 8 * (kWgStages + slot), phase ^ 1);
            bulk_load(base + slot * kWgSlot, w + W.off + (size_t)s * 64 * W.nw, W.nw * 128, bars + 8 * slot);
            if (++slot == kWgStages) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, t = threadIdx.x & 127;
    const uint32_t x0_wg = base + x0_off + wg * 64 * 128;
    unsigned char* x0s = smem + x0_off + wg * 64 * 128;
    float* sc = reinterpret_cast<float*>(smem + x0_off + p.x0_atoms * kWgRows * 128 + 2 * kWgStages * 8) +
                wg * 64 * Fill::kScratch;  // the fill's scratch
    const int F = d.num_freqs, D = d.in_dim, nf = D * F;
    WgRing ring{base, bars, 0, -1, 0};
    float acc[128];
    uint32_t a[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] = 0;

    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      // x0 of the warpgroup's 64 rows in the swizzled K-major order
      {
        const int row0 = tile * kWgRows + wg * 64;
        auto put = [&](int r, int c, float v) {
          const int off = (c >> 6) * (kWgRows * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
          *reinterpret_cast<__nv_bfloat16*>(x0s + off) = __float2bfloat16_rn(v);
        };
        auto sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };
        if constexpr (Fill::kTile) {
          fill.template tile<__nv_bfloat16>(n, row0, 64, p.x0_atoms * 64, t, 128, sc, put, sync);
        } else {
          // thread t prepares and writes row t % 64 (so no barrier between
          // the two), every other frequency / column from t / 64; one
          // sincosf per (row, dimension, frequency)
          fill.template prepare<__nv_bfloat16>(n, row0, 64, t, 128, sc);
          const int r = t & 63, par = t >> 6;
          const int row = row0 + r;
          const bool in = row < n;
          for (int dd = 0; dd < (F > 0 ? D : 0); ++dd) {
            const float xv = in ? fill.value(sc, row, r, dd) : 0.f;
            for (int k = par; k < F; k += 2) {
              float sv, cv;
              sincosf(xv * freqs[k], &sv, &cv);  // one product
              put(r, dd * F + k, sv);
              put(r, nf + dd * F + k, cv);
            }
          }
          // raw input columns, then zeros up to the atoms' edge
          for (int c = 2 * nf + par; c < p.x0_atoms * 64; c += 2)
            put(r, c, in && c < d.enc_dim ? fill.value(sc, row, r, c - 2 * nf) : 0.f);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        sync();
      }
      const int row = tile * kWgRows + wg * 64 + (warp & 3) * 16 + (lane >> 2);
      for (int li = 0; li < d.num_layers; ++li) {
        const WgLayer& W = p.layers[li];
        const LayerDesc& L = d.layers[li];
        const bool last = li == d.num_layers - 1;
        switch (W.nw) {
          case 16:
            wide_layer<16>(acc, a, W, L, x0_wg, ring, bias, last, out, out_stride, row, n, d);
            break;
          case 32:
            wide_layer<32>(acc, a, W, L, x0_wg, ring, bias, last, out, out_stride, row, n, d);
            break;
          case 64:
            wide_layer<64>(acc, a, W, L, x0_wg, ring, bias, last, out, out_stride, row, n, d);
            break;
          case 128:
            wide_layer<128>(acc, a, W, L, x0_wg, ring, bias, last, out, out_stride, row, n, d);
            break;
          default:
            wide_layer<256>(acc, a, W, L, x0_wg, ring, bias, last, out, out_stride, row, n, d);
            break;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side

// desc holds kDescHeader ints (the MlpDesc header in field order) then
// kDescPerLayer ints per layer (the LayerDesc fields in order).
bool parse_desc(const int* desc, int desc_len, MlpDesc& d) {
  if (desc_len < kDescHeader) return false;
  d.num_layers = desc[0];
  d.in_dim = desc[1];
  d.in_pad = desc[2];
  d.enc_dim = desc[3];
  d.num_freqs = desc[4];
  d.include_input = desc[5];
  d.hid_pad = desc[6];
  d.out_dim = desc[7];
  d.out_sigmoid = desc[8];
  if (d.num_layers < 1 || d.num_layers > kMaxLayers ||
      desc_len != kDescHeader + kDescPerLayer * d.num_layers)
    return false;
  for (int i = 0; i < d.num_layers; ++i) {
    const int* l = desc + kDescHeader + kDescPerLayer * i;
    d.layers[i] = LayerDesc{l[0], l[1], l[2], l[3], l[4]};
  }
  return true;
}

int num_sms() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

// CTAs of a narrow kernel that fit on one SM with `smem` bytes each, cached
// per (device, kernel, smem): the grid depends only on these.
template <typename Kernel>
int narrow_blocks_per_sm(Kernel kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> cache;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, reinterpret_cast<const void*>(kernel), smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) != cudaSuccess || blocks < 1)
    blocks = 1;
  cache[key] = blocks;
  return blocks;
}

// Whether the f32 kernel takes a stack: its shared memory fits (a product
// wider than 256 columns runs in column passes).
bool f32_ok(const MlpDesc& d) {
  return f32_smem(d).total <= (size_t)kSmemLimit;
}

// The forward path of a stack: the f32 kernel for f32 compute; for bf16
// the narrow kernel when narrow_ok, else the wide kernel when it has a plan
// for the stack and its shared memory fits; -1 when no kernel takes it.
// (A fill's scratch takes a little more: launch_fwd refuses the rare stack
// whose total then no longer fits.)
int fwd_path(const MlpDesc& d, int bf16) {
  if (!bf16) return f32_ok(d) ? kPathF32 : -1;
  if (narrow_ok(d)) return kPathNarrow;
  WgPlan p;
  long long elems = 0;
  if (make_wg_plan(d, elems, p) && wg_smem(p) <= (size_t)kSmemLimit) return kPathWgmma;
  return -1;
}

// One forward on stream s: its x0 from fill, out rows of out_stride
// elements (the first out_dim written), on the path fwd_path picks. w is
// the packed weights (mma B-fragment order for bf16, row-major f32 for
// f32); the wide path reads w_wg instead, the wgmma-order weights of
// wg_elems elements, which must be the length its plan gives.
template <typename Fill>
cudaError_t launch_fwd(const Fill& fill, const void* w, const void* w_wg, long long wg_elems,
                       const float* bias, const float* freqs, void* out, int out_stride, int n,
                       const MlpDesc& d, int bf16, cudaStream_t s) {
  cudaError_t err;
  const int path = fwd_path(d, bf16);
  if (path == kPathF32) {
    const size_t smem = f32_smem(d, Fill::kScratch).total;
    if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
    const auto kernel = f32_fwd_wide(d) ? fused_mlp_fwd_f32<Fill, true> : fused_mlp_fwd_f32<Fill, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<cdiv(n, kF32Rows), kF32Threads, smem, s>>>(fill, static_cast<const float*>(w), bias, freqs,
                                                         static_cast<float*>(out), out_stride, n, d);
  } else if (path == kPathNarrow) {
    const size_t smem = narrow_smem(d, Fill::kScratch).total;
    if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
    const auto kernel = fused_mlp_fwd_narrow<Fill>;
    const int tiles = cdiv(n, kNarrowRows);
    const int fit = num_sms() * narrow_blocks_per_sm(kernel, smem);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<tiles < fit ? tiles : fit, kThreads, smem, s>>>(fill, static_cast<const uint4*>(w), bias, freqs,
                                                             static_cast<__nv_bfloat16*>(out), out_stride, n, d,
                                                             tiles);
  } else if (path == kPathWgmma) {
    WgPlan p;
    long long elems = 0;
    make_wg_plan(d, elems, p);
    if (elems != wg_elems || w_wg == nullptr) return cudaErrorInvalidValue;
    const size_t smem = wg_smem(p, Fill::kScratch);
    if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
    p.tiles = cdiv(n, kWgRows);
    const int sms = num_sms();
    const auto kernel = fused_mlp_fwd_wgmma<Fill>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<p.tiles < sms ? p.tiles : sms, kWgThreads, smem, s>>>(
        fill, static_cast<const __nv_bfloat16*>(w_wg), bias, freqs, static_cast<__nv_bfloat16*>(out), out_stride,
        n, d, p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The forward's plan of a stack (no device work): *path the FwdPath that
// launch_fwd takes for it, -1 if none; on the wide path, per layer four
// ints of `layers` (kMaxLayers x 4), its WgLayer (nw, slices_x0, slices_h,
// off), and *elems the length of the wgmma-order weights (else 0).
// Returns 0, or cudaErrorInvalidValue for a malformed descriptor.
extern "C" int fused_mlp_fwd_plan(const int* desc, int desc_len, int bf16, int* path, int* layers,
                                  long long* elems) {
  MlpDesc d;
  if (!parse_desc(desc, desc_len, d)) return (int)cudaErrorInvalidValue;
  *path = fwd_path(d, bf16);
  *elems = 0;
  if (*path == kPathWgmma) {
    WgPlan p;
    make_wg_plan(d, *elems, p);
    for (int i = 0; i < d.num_layers; ++i) {
      const WgLayer& L = p.layers[i];
      layers[4 * i] = L.nw;
      layers[4 * i + 1] = L.slices_x0;
      layers[4 * i + 2] = L.slices_h;
      layers[4 * i + 3] = L.off;
    }
  }
  return 0;
}

// Returns the cudaError_t of the launch (0 on success); desc as parse_desc
// reads it, bf16 the compute dtype (0: f32).
extern "C" int fused_mlp_fwd(const void* x, const void* w, const void* w_wg, long long wg_elems,
                             const void* bias, const void* freqs, void* out, int n, const int* desc,
                             int desc_len, int bf16, int device, void* stream) {
  MlpDesc d;
  if (!parse_desc(desc, desc_len, d) || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd(XFill{static_cast<const float*>(x), d.in_dim}, w, w_wg, wg_elems,
                         static_cast<const float*>(bias), static_cast<const float*>(freqs), out, d.out_dim, n, d,
                         bf16, reinterpret_cast<cudaStream_t>(stream));
}
