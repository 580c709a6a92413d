// Fused-MLP backward for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes). Wrapper, plain PyTorch version (fused_mlp_bwd_plain)
// and the weight packing live in nerfstudio_thermal_torch/ops/cuda/fused_mlp.py.
//
// Replaces the TPU kernel nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:
// _bwd_kernel (entry point _fused_mlp_bwd). Function, with the rounding
// points of _mlp_bwd_walk: recompute the forward of the MLP (encoding in f32
// rounded to the compute dtype, each layer's output rounded to it); then
// from g (rounded to the compute dtype) walk back: dh = g (times y(1-y) of
// the f32 final pre-activation for a sigmoid head); for each layer from the
// last: mask dh by post_act(compute dtype) > 0 (hidden layers), db += sum of
// dh in f32, dhc = dh rounded to the compute dtype, dW += x_in^T dhc and
// dh_in = dhc W^T with f32 accumulation; a skip layer's x0 columns of dh_in
// go to dx0, as do layer 0's. The encoding backward runs in f32:
// d_pre = d_sin cos(pre) - d_cos sin(pre), dx = sum_k d_pre f_k (+ the
// include_input columns). Without the encoding dx is dx0 rounded to the
// compute dtype. dW and db are f32.
//
// What bounds it: recompute + dX + dW are three times the forward's
// products, 6 N * 429,568 FLOP for the base field of thermal-nerfacto-tpu
// (8 x 256, skip at 4, 10 frequencies, 63 -> 16): 0.68 ms at N = 262,144 at
// the H100's 989 TFLOP/s dense bf16. Its own inputs and outputs are 56 bytes
// a point (x, g, dx), so it is bound by operations. A proposal stack (48 ->
// 64 -> 64 -> 16 padded, no input gradient) does 6 N * ~6.3k FLOP, 0.04 ms
// per million points, against ~30 bytes a point: bound by operations too,
// but so small a block of work per point that the schedule, not the tensor
// cores, sets its time.
//
// Design. The TPU kernel runs its grid in order and sums dW/db with += into
// VMEM-resident outputs. Here blocks run in parallel, so dW/db end in
// per-block slabs that fixed-order sums add (no atomics: the same bits every
// run). launch_all picks one of two paths from the descriptor:
//
// Narrow path (bf16, no skip layer, every padded width <= 64: the proposal
// stacks, the colour head): one persistent kernel, fused_mlp_bwd_narrow.
// Each CTA copies both packed weight arrays into shared memory once and
// takes 128-point tiles blockIdx.x, + gridDim.x, ... (the partition depends
// only on the grid). A warp owns 16 rows of a tile across every column, so
// all 8 warps work in every layer; the recompute chains each layer's
// rounded accumulators into the next product's A fragments, and keeps the
// activations in shared memory for the masks and dW. The walk forms each
// layer's mask, db partial (a fixed-order butterfly over the row lanes)
// and rounding on the accumulators, writes dhc to shared memory, and after
// one barrier every warp adds x_in^T dhc of the whole tile into its own
// dW tiles (m16n8, ldmatrix.trans), which stay in registers across tiles.
// Nothing goes through device memory but x, g, dx and one dW/db slab per
// CTA; two CTAs fit on an SM.
//
// Wide path (8 x 256 with its skip, a 16-wide output layer or, in the
// frequency NeRF's base stack, a 256-wide one over a 63- or 99-wide
// pre-encoded input; f32 always) streams, as the TPU's
// _fwd_save/_bwd_saved pair does, because every layer's activations (3.5
// KB a point) do not fit in shared memory beside the gradient buffers:
//   1. walk (one CTA per 64 points: 16 warps of 32 rows x 32 columns in
//      bf16, 8 warps in f32): encoding into shared memory;
//      forward recompute through two shared-memory buffers, writing the
//      encoding and every hidden activation to a workspace in device
//      memory; then the walk back, layer by layer, dhc to the workspace;
//      per-CTA db partials; the encoding backward gives dx. In bf16 the
//      weights stream through a ring of cp.async K-slices in shared memory
//      (both row warps read one copy, the next slices load while one
//      multiplies), A fragments come by ldmatrix, and every epilogue works
//      on the accumulators: relu-mask words by shuffles in the forward;
//      mask, db (shuffle sums over a warp's rows, then the two row warps in
//      order) and rounding in the walk, with no f32 dh buffer.
//   2. dW (one CTA of 8 warps per tile of a layer's dW and per range of
//      points): dW_tile = sum over points of x_in^T dhc from the workspace.
//      bf16: the tile follows the layer (64 x 256 for the 64-row input and
//      skip layers, 128 x 128, 256 x 64 for the 16-wide output layer) so
//      no warp idles, and 64-point chunks stream through two cp.async
//      stages (one loads while the other multiplies), read with
//      ldmatrix.trans.
//   3. fixed-order sums of the partial slabs give dW and db.
// Products run as bf16 mma.sync m16n8k16 with f32 accumulation; the f32
// compute path is a plain FMA loop on the CUDA cores (no TF32) on the wide
// path. The wide path's workspace costs about 7.3 KB a point of device
// memory (1.9 GB at N = 262,144) and as much traffic each way. Its walk
// runs mma.sync at ~130 TFLOP/s, latency-bound with one 64-point CTA per
// SM (its 213 KB of shared memory allow no second); wgmma and more points
// per CTA are what it still gives up. Loading the weights costs it little:
// with the copies left out, an 8-warp version of the walk took 11% less
// time (H100, bf16).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: the top frequency reaches
// ~3217 rad per unit of x, where __sinf/__cosf lose all accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "fused_mlp_common.cuh"

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 64;         // points per CTA, walk kernel
constexpr int kTile32 = 64;     // dW tile edge, f32 path
constexpr int kChunk = 32;      // points per shared-memory stage, f32 dW kernel
constexpr int kSumGroup = 64;   // slabs summed per block in the first stage
constexpr int kNarrowRows = 128;   // points per tile of the one-pass kernel: 8 warps x 16
constexpr int kNarrowWidth = 64;   // widest padded layer the one-pass kernel takes
constexpr int kNarrowSlots = 9;    // dW m16n8 tiles per warp, one-pass kernel
constexpr int kNarrowDims = 4;     // input dims of an encoded input, one-pass kernel
constexpr int kSmemLimit = 232448; // shared memory one block may use
constexpr int kStages = 3;         // weight K-slices in flight, bf16 walk
constexpr int kSliceKt = 4;        // 16-wide k-tiles per weight slice, bf16 walk
constexpr int kWalkWarpCols = 32;  // output columns per warp in a 256-column pass, bf16 walk
constexpr int kWalkNt = kWalkWarpCols / 8;     // its n-tiles
constexpr int kWalkPairs = kWalkNt / 2;        // its 16-column pairs
constexpr int kWalkWords = kWalkWarpCols / 32;  // its 32-column relu-mask words
constexpr int kWalkThreads = 2 * (256 / kWalkWarpCols) * 32;  // 2 row warps per column group
constexpr int kDwStages = 2;       // point chunks in flight, bf16 dW kernel
constexpr int kDwChunk = 64;       // points per stage, bf16 dW kernel
constexpr int kDwTileArea = 128 * 128;  // dW tile elements, bf16 (8 warps of 32 x 64)
constexpr int kDescHeader = 9;
constexpr int kDescPerLayer = 5;

struct LayerDesc {
  int k_pad;  // padded input width (multiple of 16)
  int n_pad;  // padded output width (multiple of 16)
  int skip;   // 1: the input is concat([x0, h])
  int w_off;  // offset of the packed weights (elements); also of dW
  int b_off;  // offset of the bias (floats); also of db
};

struct MlpDesc {
  int num_layers;
  int in_dim;
  int in_pad;
  int enc_dim;
  int num_freqs;
  int include_input;
  int hid_pad;
  int out_dim;
  int out_sigmoid;
  int dx_exact;  // no encoding: dx is dx0 in f32, not rounded (not from desc)
  int no_dx;     // no input gradient: layer 0's dX product and dx are skipped (not from desc)
  LayerDesc layers[kMaxLayers];
};

// Where everything lives: element offsets into the workspace (compute
// dtype) and float offsets into the scratch buffer.
struct Plan {
  int narrow;          // 1: the one-pass kernel (no workspace), 0: three stages
  int rows;            // points padded to a multiple of kBM
  int walk_blocks;     // rows / kBM
  int tasks;           // dW tiles over all layers
  int splits;          // point ranges per dW tile
  int rows_per_split;  // multiple of the dW chunk
  int tiles;           // narrow: tiles of kNarrowRows points
  int grid;            // narrow: persistent CTAs, one dW/db slab each
  int total_w;         // sum k_pad * n_pad
  int total_b;         // sum n_pad
  int tile_m[kMaxLayers];  // bf16 dW tile rows per layer (columns: kDwTileArea / rows)
  size_t dw_smem;          // dynamic shared memory of the bf16 dW kernel
  long long ws_elems;
  long long x0;
  long long act[kMaxLayers];  // hidden outputs, layers 0..L-2: [rows, n_pad]
  long long dh[kMaxLayers];   // dhc of every layer: [rows, n_pad]
  long long dw_slab;          // [splits (narrow: grid), total_w]
  long long db_slab;          // [walk_blocks (narrow: grid), total_b]
  long long db_tmp;           // [ceil(walk_blocks / kSumGroup), total_b]
  long long scratch_floats;
  size_t smem;                // dynamic shared memory of the walk / one-pass kernel
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int layer_tiles(const LayerDesc& L, int tile) {
  return cdiv(L.k_pad, tile) * cdiv(L.n_pad, tile);
}

// Shared memory of the walk kernel (bytes), for element size es (2 or 4).
// bf16: the walk's dh is formed on the accumulators, so dhc ping-pongs
// between the two activation buffers; the warps' db partials and a ring of
// weight K-slices (kStages x kSliceKt k-tiles of up to 256 columns, in
// B-fragment order) follow. f32: dhc and an f32 dh buffer share the
// activation buffers' bytes.
struct Smem {
  int x0_stride, h_stride, f_stride, d_stride, o_stride, words, wid;
  size_t x0, ha, hb, dhc, dhf, dx0, fpre, mask, dbw, ring, total;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline Smem smem_layout(const MlpDesc& d, int es) {
  Smem s;
  const int pad = es == 2 ? 8 : 1;
  const int out_pad = d.layers[d.num_layers - 1].n_pad;
  const int wid = d.hid_pad > out_pad ? d.hid_pad : out_pad;  // widest dh
  s.wid = wid;
  s.x0_stride = d.in_pad + pad;
  s.h_stride = wid + pad;
  s.f_stride = wid + 4;
  s.d_stride = d.in_pad + 4;
  s.o_stride = out_pad + 4;
  size_t off = 0;
  s.x0 = off;
  off += align16((size_t)kBM * s.x0_stride * es);
  const size_t h_bytes = align16((size_t)kBM * s.h_stride * es);
  s.ha = off;
  s.hb = off + h_bytes;
  s.dhc = off;
  s.dhf = off + h_bytes;
  const size_t fwd_end = s.hb + h_bytes;
  const size_t walk_end = es == 2 ? fwd_end : s.dhf + align16((size_t)kBM * s.f_stride * 4);
  off = fwd_end > walk_end ? fwd_end : walk_end;
  s.dx0 = off;
  off += align16((size_t)kBM * s.d_stride * 4);
  // the last layer's f32 pre-activation, kept only for a sigmoid head
  // (y(1-y)); without one a 256-wide output layer leaves its 66 KB to the
  // ring
  s.fpre = off;
  if (d.out_sigmoid) off += align16((size_t)kBM * s.o_stride * 4);
  // relu masks of the hidden layers, one bit per activation > 0
  s.words = (wid + 31) / 32;
  s.mask = off;
  off += align16((size_t)(d.num_layers > 1 ? d.num_layers - 1 : 1) * kBM * s.words * 4);
  s.dbw = off;
  s.ring = off;
  if (es == 2) {
    off += align16((size_t)2 * wid * 4);
    s.ring = off;
    off += (size_t)kStages * kSliceKt * 16 * 32 * 16;
  }
  s.total = off;
  return s;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The weight slices of every product of the bf16 walk, in the order the
// walk multiplies them: the forward's layers (the last only for a sigmoid
// head), then W^T from the last layer down (layer 0 only with dx); each
// product in passes of up to 256 columns, each pass in slices of kSliceKt
// k-tiles. cp.async keeps kStages - 1 slices in flight ahead of the
// product that reads them, across layer boundaries, into a ring of
// kStages shared-memory slots (B-fragment order, as packed).
constexpr int kSlot = kSliceKt * 16 * 32;  // uint4 per ring slot

struct SliceStream {
  const uint4* w;
  const uint4* wt;
  uint4* ring;
  int fwd_products, products;
  int prod, pass, sl;  // the next slice to issue
  int slices, passes, np_total, kt_total;  // its product's shape
  const uint4* wl;
  int issued, consumed;

  __device__ __forceinline__ void init(const MlpDesc& d, const uint4* w_, const uint4* wt_,
                                       uint4* ring_) {
    w = w_;
    wt = wt_;
    ring = ring_;
    fwd_products = d.num_layers - (d.out_sigmoid ? 0 : 1);
    products = fwd_products + d.num_layers - (d.no_dx ? 1 : 0);
    prod = pass = sl = issued = consumed = 0;
    shape(d);
  }

  // weights, n-tile pairs, k-tiles, passes and slices of product prod
  __device__ __forceinline__ void shape(const MlpDesc& d) {
    if (prod >= products) return;
    if (prod < fwd_products) {
      const LayerDesc& L = d.layers[prod];
      wl = w + L.w_off / 8;
      np_total = L.n_pad / 16;
      kt_total = L.k_pad / 16;
    } else {
      const LayerDesc& L = d.layers[d.num_layers - 1 - (prod - fwd_products)];
      wl = wt + L.w_off / 8;
      np_total = L.k_pad / 16;
      kt_total = L.n_pad / 16;
    }
    passes = cdiv(np_total, 16);
    slices = cdiv(kt_total, kSliceKt);
  }

  // Every thread: copy the next slice (if any) into its ring slot and
  // commit one cp.async group.
  __device__ __forceinline__ void issue(const MlpDesc& d) {
    if (prod < products) {
      const int pbeg = pass * 16;
      const int per_kt = (np_total - pbeg < 16 ? np_total - pbeg : 16) * 32;
      const int kt_a = sl * kSliceKt;
      uint4* dst = ring + (issued % kStages) * kSlot;
#pragma unroll
      for (int kk = 0; kk < kSliceKt; ++kk) {
        if (kt_a + kk >= kt_total) break;
        const uint4* src = wl + ((size_t)(kt_a + kk) * np_total + pbeg) * 32;
        for (int i = threadIdx.x; i < per_kt; i += blockDim.x) cp_async16(dst + kk * per_kt + i, src + i);
      }
      ++issued;
      if (++sl == slices) {
        sl = 0;
        if (++pass == passes) {
          pass = 0;
          ++prod;
          shape(d);
        }
      }
    }
    cp_async_commit();
  }

  // Wait for the next slice, keep the ring kStages - 1 slices ahead, and
  // return the slice's slot. Every thread of the block calls it.
  __device__ __forceinline__ const uint4* next(const MlpDesc& d) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the slice landed for every thread; the slot read before it is free
    issue(d);
    return ring + (consumed++ % kStages) * kSlot;
  }
};

// C[kBM, n_cols] = A[kBM, K] B[K, n_cols] on the tensor cores, bf16 walk.
// A is read from shared memory with ldmatrix in two K segments (kt0
// 16-wide tiles of src0, then src1); B, packed in mma B-fragment order (see
// fused_mlp.py _fragment_index), comes slice by slice from the stream, so
// both row warps read one copy while the next slices load. Warps: 2 along
// M (32 rows) x 256 / kWalkWarpCols along N per 256-column pass;
// epi(acc, col0) receives a warp's accumulators (mma C layout: rows wm 32 +
// mt 16 + g (+ 8), columns col0 + nt 8 + 2q (+ 1)). Every thread of the
// block calls it, in the stream's product order.
template <class Epi>
__device__ __forceinline__ void product_wide(const __nv_bfloat16* src0, int stride0, int kt0,
                                             const __nv_bfloat16* src1, int stride1, int kt_total,
                                             int n_cols, const MlpDesc& d, SliceStream& stream,
                                             Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int np_total = n_cols / 16;
  const int slices = cdiv(kt_total, kSliceKt);
  for (int nb = 0; nb < n_cols; nb += 256) {
    const int pcnt = np_total - nb / 16 < 16 ? np_total - nb / 16 : 16;
    const int pw = wn * kWalkPairs;  // this warp's first n-tile pair in the pass
    const bool active = pw < pcnt;  // warp-uniform
    float acc[2][kWalkNt][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kWalkNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      const uint4* slot = stream.next(d);
      if (!active) continue;
#pragma unroll
      for (int kk = 0; kk < kSliceKt; ++kk) {
        const int kt = sl * kSliceKt + kk;
        if (kt >= kt_total) break;
        const __nv_bfloat16* src;
        int stride, kc;
        if (kt < kt0) {
          src = src0; stride = stride0; kc = kt * 16;
        } else {
          src = src1; stride = stride1; kc = (kt - kt0) * 16;
        }
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a[mt], src + (wm * 32 + mt * 16 + (lane & 15)) * stride + kc + (lane >> 4) * 8);
#pragma unroll
        for (int pp = 0; pp < kWalkPairs; ++pp) {
          if (pw + pp < pcnt) {
            const uint4 bv = slot[(kk * pcnt + pw + pp) * 32 + lane];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][2 * pp], a[mt], bv.x, bv.y);
              mma_bf16(acc[mt][2 * pp + 1], a[mt], bv.z, bv.w);
            }
          }
        }
      }
    }
    if (active) epi(acc, nb + wn * kWalkWarpCols);
  }
}

// The same product in exact f32 on the CUDA cores: K segments of k0 and
// k_total - k0 columns, B row-major [K, n_cols]. Thread (rg, cl) owns rows
// 4 rg .. 4 rg + 3 and columns cl + 16 j of each 64-column pass.
template <class Epi>
__device__ __forceinline__ void product_f32(const float* src0, int stride0, int k0,
                                            const float* src1, int stride1, int k_total,
                                            const float* __restrict__ wl, int n_cols, Epi epi) {
  const int rg = threadIdx.x >> 4, cl = threadIdx.x & 15;
  for (int nb = 0; nb < n_cols; nb += 64) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < k_total; ++k) {
      const float* src = k < k0 ? src0 + k : src1 + (k - k0);
      const int stride = k < k0 ? stride0 : stride1;
      float a[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = src[(rg * 4 + i) * stride];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb + cl + 16 * j;
        wv[j] = c < n_cols ? __ldg(wl + (size_t)k * n_cols + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = nb + cl + 16 * j;
      if (c >= n_cols) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) epi(rg * 4 + i, c, acc[i][j]);
    }
  }
}

// Copy a [kBM, n] tile from shared memory (row stride `stride`) to the
// workspace rows starting at dst (row stride n), 16 bytes at a time in bf16.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int stride, int n) {
  if constexpr (sizeof(T) == 2) {
    const int chunks = n / 8;
    for (int i = threadIdx.x; i < kBM * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      *reinterpret_cast<uint4*>(dst + (size_t)r * n + c) =
          *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * n; i += blockDim.x) {
      const int r = i / n, c = i - r * n;
      dst[(size_t)r * n + c] = src[r * stride + c];
    }
  }
}

// Column sums of dhf[:, 0:n] over the block's rows, in row order, into the
// CTA's db partial.
__device__ __forceinline__ void column_sums(const float* dhf, int f_stride, int n, float* dbp) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float colsum = 0.f;
    for (int r = 0; r < kBM; ++r) colsum += dhf[r * f_stride + c];
    dbp[c] = colsum;
  }
}

// Encoding (or raw input) of the block's kBM points into x0 (shared
// memory) and the workspace, zero beyond enc_dim and beyond n.
template <typename T>
__device__ __forceinline__ void encode_block(const float* __restrict__ x,
                                             const float* __restrict__ freqs, T* x0, int x0_stride,
                                             T* ws_x0, int row0, int n, const MlpDesc& d) {
  const int F = d.num_freqs, D = d.in_dim, nf = D * F;
  for (int i = threadIdx.x; i < kBM * d.in_pad; i += blockDim.x) {
    const int r = i / d.in_pad, c = i - r * d.in_pad;
    const int row = row0 + r;
    float v = 0.f;
    if (row < n && c < d.enc_dim) {
      const float* xr = x + (size_t)row * D;
      if (F > 0 && c < 2 * nf) {
        const int cc = c < nf ? c : c - nf;
        const int dd = cc / F;
        const float pre = xr[dd] * freqs[cc - dd * F];  // one product
        v = c < nf ? sinf(pre) : cosf(pre);
      } else {
        v = xr[F > 0 ? c - 2 * nf : c];
      }
    }
    const T tv = from_f32<T>(v);
    x0[r * x0_stride + c] = tv;
    ws_x0[(size_t)row * d.in_pad + c] = tv;
  }
}

// dx of the block's points from dx0 (shared memory, f32): the encoding
// backward in f32, or dx0 (rounded to T unless dx_exact).
template <typename T>
__device__ __forceinline__ void dx_block(const float* __restrict__ x, const float* __restrict__ freqs,
                                         const float* dx0, int d_stride, float* __restrict__ dx,
                                         int row0, int n, const MlpDesc& d) {
  const int F = d.num_freqs, D = d.in_dim, nf = D * F;
  for (int i = threadIdx.x; i < kBM * D; i += blockDim.x) {
    const int r = i / D, dd = i - r * D;
    const int row = row0 + r;
    if (row >= n) continue;
    const float* d0 = dx0 + r * d_stride;
    float acc;
    if (F > 0) {
      const float xv = x[(size_t)row * D + dd];
      acc = 0.f;
      for (int k = 0; k < F; ++k) {
        const float f = freqs[k];
        const float pre = xv * f;
        const int c = dd * F + k;
        const float dpre = d0[c] * cosf(pre) - d0[nf + c] * sinf(pre);
        acc += dpre * f;
      }
      if (d.include_input) acc += d0[2 * nf + dd];
    } else {
      acc = d.dx_exact ? d0[dd] : to_f32(from_f32<T>(d0[dd]));
    }
    dx[(size_t)row * D + dd] = acc;
  }
}

// Kernel 1, bf16: recompute, walk back, dx and per-CTA db partials. Every
// epilogue works on the product's accumulators: bias, relu, rounding and
// the relu-mask words (an OR over the four column lanes) in the forward;
// mask, db partials (fixed-order sums over a warp's 32 rows by shuffles,
// then over the two row warps) and rounding in the walk, where dhc
// ping-pongs between the two activation buffers.
__global__ void __launch_bounds__(kWalkThreads, 1)
fused_mlp_bwd_walk_bf16(const float* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                        const uint4* __restrict__ w, const uint4* __restrict__ wt,
                        const float* __restrict__ bias, const float* __restrict__ freqs,
                        __nv_bfloat16* ws, float* __restrict__ scratch, float* __restrict__ dx,
                        int n, MlpDesc d, Plan plan) {
  using B16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = smem_layout(d, 2);
  B16* x0 = reinterpret_cast<B16*>(smem + s.x0);
  B16* ha = reinterpret_cast<B16*>(smem + s.ha);
  B16* hb = reinterpret_cast<B16*>(smem + s.hb);
  float* dx0 = reinterpret_cast<float*>(smem + s.dx0);
  float* fpre = reinterpret_cast<float*>(smem + s.fpre);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + s.mask);
  float* dbw = reinterpret_cast<float*>(smem + s.dbw);
  float* dbp = scratch + plan.db_slab + (size_t)blockIdx.x * plan.total_b;
  const int row0 = blockIdx.x * kBM;
  const int L = d.num_layers;
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) & 1;
  const int gq = lane >> 2, q = lane & 3;
  const int hs = s.h_stride;
  SliceStream stream;
  stream.init(d, w, wt, reinterpret_cast<uint4*>(smem + s.ring));
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stream.issue(d);

  encode_block(x, freqs, x0, s.x0_stride, ws + plan.x0, row0, n, d);
  for (int i = threadIdx.x; i < kBM * d.in_pad; i += blockDim.x) {
    dx0[(i / d.in_pad) * s.d_stride + i % d.in_pad] = 0.f;
  }

  // forward recompute; the last layer only for a sigmoid head (its f32
  // pre-activation feeds y(1-y))
  bool flip = false;
  for (int li = 0; li < L; ++li) {
    const LayerDesc Ld = d.layers[li];
    const bool last = li == L - 1;
    if (last && !d.out_sigmoid) break;
    const int kt0 = (li == 0 || Ld.skip) ? d.in_pad / 16 : 0;
    const B16* hin = flip ? hb : ha;
    B16* hout = flip ? ha : hb;
    const float* bl = bias + Ld.b_off;
    uint32_t* ml = mask + (size_t)li * kBM * s.words;
    product_wide(x0, s.x0_stride, kt0, hin, hs, Ld.k_pad / 16, Ld.n_pad, d, stream,
                 [&](const float (&acc)[2][kWalkNt][4], int col0) {
                   if (last) {
#pragma unroll
                     for (int nt = 0; nt < kWalkNt; ++nt) {
                       const int c = col0 + nt * 8 + 2 * q;
                       if (c >= Ld.n_pad) continue;
#pragma unroll
                       for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                         for (int h2 = 0; h2 < 2; ++h2) {
                           float* o = fpre + (wm * 32 + mt * 16 + gq + 8 * h2) * s.o_stride + c;
                           o[0] = acc[mt][nt][2 * h2] + bl[c];
                           o[1] = acc[mt][nt][2 * h2 + 1] + bl[c + 1];
                         }
                     }
                     return;
                   }
                   uint32_t bits[2][2][kWalkWords] = {};  // [mt][row half][32-column word]
#pragma unroll
                   for (int nt = 0; nt < kWalkNt; ++nt) {
                     const int c = col0 + nt * 8 + 2 * q;
                     if (c >= Ld.n_pad) continue;
                     const float b0 = bl[c], b1 = bl[c + 1];
#pragma unroll
                     for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                       for (int h2 = 0; h2 < 2; ++h2) {
                         const uint32_t hv = pack_bf16(fmaxf(acc[mt][nt][2 * h2] + b0, 0.f),
                                                       fmaxf(acc[mt][nt][2 * h2 + 1] + b1, 0.f));
                         *reinterpret_cast<uint32_t*>(hout + (wm * 32 + mt * 16 + gq + 8 * h2) * hs + c) = hv;
                         const int bit = (nt & 3) * 8 + 2 * q;
                         bits[mt][h2][nt >> 2] |= (bf16_lo(hv) > 0.f ? 1u : 0u) << bit;
                         bits[mt][h2][nt >> 2] |= (bf16_hi(hv) > 0.f ? 1u : 0u) << (bit + 1);
                       }
                   }
#pragma unroll
                   for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                     for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
                       for (int wd = 0; wd < kWalkWords; ++wd) {
                         uint32_t v = bits[mt][h2][wd];
                         v |= __shfl_xor_sync(0xffffffffu, v, 1);
                         v |= __shfl_xor_sync(0xffffffffu, v, 2);
                         if (q == 0 && col0 + 32 * wd < Ld.n_pad)
                           ml[(wm * 32 + mt * 16 + gq + 8 * h2) * s.words + col0 / 32 + wd] = v;
                       }
                 });
    __syncthreads();
    if (!last) store_tile(ws + plan.act[li] + (size_t)row0 * Ld.n_pad, hout, hs, Ld.n_pad);
    flip = !flip;
  }

  // last layer: dh from g, into ha (the activations are no longer read)
  B16* dhc_in = ha;
  B16* dhc_out = hb;
  {
    const LayerDesc Ld = d.layers[L - 1];
    auto dh_last = [&](int r, int c) {
      const int row = row0 + r;
      float v = 0.f;
      if (row < n && c < d.out_dim) {
        v = __bfloat162float(g[(size_t)row * d.out_dim + c]);
        if (d.out_sigmoid) {
          const float y = 1.f / (1.f + expf(-fpre[r * s.o_stride + c]));
          v = v * y * (1.f - y);
        }
      }
      return v;
    };
    __syncthreads();  // the forward's last readers of ha are done
    B16* dst = ws + plan.dh[L - 1] + (size_t)row0 * Ld.n_pad;
    for (int i = threadIdx.x; i < kBM * Ld.n_pad; i += blockDim.x) {
      const int r = i / Ld.n_pad, c = i - r * Ld.n_pad;
      const B16 tv = __float2bfloat16_rn(dh_last(r, c));
      dhc_in[r * hs + c] = tv;
      dst[i] = tv;
    }
    for (int c = threadIdx.x; c < Ld.n_pad; c += blockDim.x) {
      float colsum = 0.f;
      for (int r = 0; r < kBM; ++r) colsum += dh_last(r, c);
      dbp[Ld.b_off + c] = colsum;
    }
  }

  // walk back: dh_in = dhc W^T; x0 columns to dx0, the rest masked by the
  // previous layer's activation, summed into db and rounded into dhc
  for (int li = L - 1; li >= 0; --li) {
    if (li == 0 && d.no_dx) break;
    const LayerDesc Ld = d.layers[li];
    const int off = (li > 0 && Ld.skip) ? d.in_pad : 0;
    const uint32_t* ml = mask + (size_t)(li > 0 ? li - 1 : 0) * kBM * s.words;
    product_wide(dhc_in, hs, Ld.n_pad / 16, dhc_in, hs, Ld.n_pad / 16, Ld.k_pad, d, stream,
                 [&](const float (&acc)[2][kWalkNt][4], int col0) {
#pragma unroll
                   for (int nt = 0; nt < kWalkNt; ++nt) {
                     const int c0 = col0 + nt * 8;  // warp-uniform
                     if (c0 >= Ld.k_pad) continue;
                     const int c = c0 + 2 * q;
                     if (li == 0 || c0 < off) {
#pragma unroll
                       for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                         for (int h2 = 0; h2 < 2; ++h2) {
                           float* o = dx0 + (wm * 32 + mt * 16 + gq + 8 * h2) * s.d_stride + c;
                           o[0] += acc[mt][nt][2 * h2];
                           o[1] += acc[mt][nt][2 * h2 + 1];
                         }
                       continue;
                     }
                     const int cc = c - off;
                     float s0 = 0.f, s1 = 0.f;
#pragma unroll
                     for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                       for (int h2 = 0; h2 < 2; ++h2) {
                         const int r = wm * 32 + mt * 16 + gq + 8 * h2;
                         const uint32_t word = ml[r * s.words + (cc >> 5)];
                         const float v0 = (word >> (cc & 31)) & 1u ? acc[mt][nt][2 * h2] : 0.f;
                         const float v1 = (word >> ((cc + 1) & 31)) & 1u ? acc[mt][nt][2 * h2 + 1] : 0.f;
                         s0 += v0;
                         s1 += v1;
                         *reinterpret_cast<uint32_t*>(dhc_out + r * hs + cc) = pack_bf16(v0, v1);
                       }
#pragma unroll
                     for (int m = 4; m < 32; m <<= 1) {
                       s0 += __shfl_xor_sync(0xffffffffu, s0, m);
                       s1 += __shfl_xor_sync(0xffffffffu, s1, m);
                     }
                     if (gq == 0) {
                       dbw[wm * s.wid + cc] = s0;
                       dbw[wm * s.wid + cc + 1] = s1;
                     }
                   }
                 });
    __syncthreads();
    if (li == 0) break;
    const LayerDesc P = d.layers[li - 1];
    for (int c = threadIdx.x; c < P.n_pad; c += blockDim.x)
      dbp[P.b_off + c] = dbw[c] + dbw[s.wid + c];
    store_tile(ws + plan.dh[li - 1] + (size_t)row0 * P.n_pad, dhc_out, hs, P.n_pad);
    B16* tmp = dhc_in;
    dhc_in = dhc_out;
    dhc_out = tmp;
  }

  if (d.no_dx) return;
  __syncthreads();
  dx_block<B16>(x, freqs, dx0, s.d_stride, dx, row0, n, d);
}

// Kernel 1, f32: recompute, walk back, dx and per-CTA db partials.
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_walk_f32(const float* __restrict__ x, const float* __restrict__ g,
                       const void* __restrict__ w, const void* __restrict__ wt,
                       const float* __restrict__ bias, const float* __restrict__ freqs,
                       float* ws, float* __restrict__ scratch, float* __restrict__ dx, int n,
                       MlpDesc d, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = smem_layout(d, 4);
  float* x0 = reinterpret_cast<float*>(smem + s.x0);
  float* ha = reinterpret_cast<float*>(smem + s.ha);
  float* hb = reinterpret_cast<float*>(smem + s.hb);
  float* dhc = reinterpret_cast<float*>(smem + s.dhc);
  float* dhf = reinterpret_cast<float*>(smem + s.dhf);
  float* dx0 = reinterpret_cast<float*>(smem + s.dx0);
  float* fpre = reinterpret_cast<float*>(smem + s.fpre);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + s.mask);
  float* dbp = scratch + plan.db_slab + (size_t)blockIdx.x * plan.total_b;
  const int row0 = blockIdx.x * kBM;
  const int L = d.num_layers;

  encode_block(x, freqs, x0, s.x0_stride, ws + plan.x0, row0, n, d);
  for (int i = threadIdx.x; i < kBM * d.in_pad; i += blockDim.x) {
    dx0[(i / d.in_pad) * s.d_stride + i % d.in_pad] = 0.f;
  }
  __syncthreads();

  // forward recompute; the last layer only for a sigmoid head (its f32
  // pre-activation feeds y(1-y))
  bool flip = false;
  for (int li = 0; li < L; ++li) {
    const LayerDesc Ld = d.layers[li];
    const bool last = li == L - 1;
    if (last && !d.out_sigmoid) break;
    const int k0 = (li == 0 || Ld.skip) ? d.in_pad : 0;
    const float* hin = flip ? hb : ha;
    float* hout = flip ? ha : hb;
    const float* bl = bias + Ld.b_off;
    const float* wl = static_cast<const float*>(w) + Ld.w_off;
    if (!last) {
      product_f32(x0, s.x0_stride, k0, hin, s.h_stride, Ld.k_pad, wl, Ld.n_pad,
                 [&](int r, int c, float v) {
                   hout[r * s.h_stride + c] = fmaxf(v + bl[c], 0.f);
                 });
    } else {
      product_f32(x0, s.x0_stride, k0, hin, s.h_stride, Ld.k_pad, wl, Ld.n_pad,
                 [&](int r, int c, float v) { fpre[r * s.o_stride + c] = v + bl[c]; });
    }
    __syncthreads();
    if (!last) {
      store_tile(ws + plan.act[li] + (size_t)row0 * Ld.n_pad, hout, s.h_stride, Ld.n_pad);
      uint32_t* ml = mask + (size_t)li * kBM * s.words;
      for (int i = threadIdx.x; i < kBM * s.words; i += blockDim.x) {
        const int r = i / s.words, c0 = (i - r * s.words) * 32;
        uint32_t bits = 0;
        for (int b = 0; b < 32 && c0 + b < Ld.n_pad; ++b)
          bits |= (to_f32(hout[r * s.h_stride + c0 + b]) > 0.f ? 1u : 0u) << b;
        ml[i] = bits;
      }
    }
    flip = !flip;
  }
  __syncthreads();

  // last layer: dh from g
  {
    const LayerDesc Ld = d.layers[L - 1];
    float* dst = ws + plan.dh[L - 1] + (size_t)row0 * Ld.n_pad;
    for (int i = threadIdx.x; i < kBM * Ld.n_pad; i += blockDim.x) {
      const int r = i / Ld.n_pad, c = i - r * Ld.n_pad;
      const int row = row0 + r;
      float v = 0.f;
      if (row < n && c < d.out_dim) {
        v = to_f32(g[(size_t)row * d.out_dim + c]);
        if (d.out_sigmoid) {
          const float y = 1.f / (1.f + expf(-fpre[r * s.o_stride + c]));
          v = v * y * (1.f - y);
        }
      }
      const float tv = v;
      dhf[r * s.f_stride + c] = v;
      dhc[r * s.h_stride + c] = tv;
      dst[i] = tv;
    }
    __syncthreads();
    column_sums(dhf, s.f_stride, Ld.n_pad, dbp + Ld.b_off);
  }
  __syncthreads();

  // walk back: dh_in = dhc W^T; x0 columns to dx0, the rest masked by the
  // previous layer's activation, summed into db and rounded into dhc
  for (int li = L - 1; li >= 0; --li) {
    if (li == 0 && d.no_dx) break;
    const LayerDesc Ld = d.layers[li];
    const int off = (li > 0 && Ld.skip) ? d.in_pad : 0;
    const float* wl = static_cast<const float*>(wt) + Ld.w_off;
    product_f32(dhc, s.h_stride, Ld.n_pad, dhc, s.h_stride, Ld.n_pad, wl, Ld.k_pad,
               [&](int r, int c, float v) {
                 if (li == 0 || c < off) {
                   dx0[r * s.d_stride + c] += v;
                 } else {
                   dhf[r * s.f_stride + (c - off)] = v;
                 }
               });
    __syncthreads();
    if (li == 0) break;
    const LayerDesc P = d.layers[li - 1];
    const uint32_t* ml = mask + (size_t)(li - 1) * kBM * s.words;
    float* dst = ws + plan.dh[li - 1] + (size_t)row0 * P.n_pad;
    for (int i = threadIdx.x; i < kBM * P.n_pad; i += blockDim.x) {
      const int r = i / P.n_pad, c = i - r * P.n_pad;
      const float keep = (ml[r * s.words + (c >> 5)] >> (c & 31)) & 1u ? 1.f : 0.f;
      const float v = dhf[r * s.f_stride + c] * keep;
      const float tv = v;
      dhf[r * s.f_stride + c] = v;
      dhc[r * s.h_stride + c] = tv;
      dst[i] = tv;
    }
    __syncthreads();
    column_sums(dhf, s.f_stride, P.n_pad, dbp + P.b_off);
    __syncthreads();
  }

  // dx: the encoding backward in f32, or dx0
  if (d.no_dx) return;
  dx_block<float>(x, freqs, dx0, s.d_stride, dx, row0, n, d);
}

// Which layer and tile a dW CTA owns.
__device__ __forceinline__ void dw_task(const MlpDesc& d, int tile, int& li, int& m0, int& n0) {
  int t = blockIdx.x;
  li = 0;
  for (; li < d.num_layers - 1; ++li) {
    const int c = layer_tiles(d.layers[li], tile);
    if (t < c) break;
    t -= c;
  }
  const int tn = cdiv(d.layers[li].n_pad, tile);
  m0 = (t / tn) * tile;
  n0 = (t % tn) * tile;
}

// Row m of layer li's weight (padded layout) reads column m of x0 or of the
// previous layer's activation; returns a pointer to point `p` of it.
template <typename T>
__device__ __forceinline__ const T* x_in_col(const T* ws, const MlpDesc& d, const Plan& plan,
                                             int li, int m, int p) {
  if (li == 0 || (d.layers[li].skip && m < d.in_pad)) {
    return ws + plan.x0 + (size_t)p * d.in_pad + m;
  }
  const LayerDesc P = d.layers[li - 1];
  const int mm = m - (d.layers[li].skip ? d.in_pad : 0);
  return ws + plan.act[li - 1] + (size_t)p * P.n_pad + mm;
}

// Which layer and tile a bf16 dW CTA owns: tiles of tile_m[li] x
// (kDwTileArea / tile_m[li]), layer by layer.
__device__ __forceinline__ void dw_task_bf16(const MlpDesc& d, const Plan& plan, int& li, int& m0,
                                             int& n0) {
  int t = blockIdx.x;
  li = 0;
  for (; li < d.num_layers - 1; ++li) {
    const int tm = plan.tile_m[li];
    const int c = cdiv(d.layers[li].k_pad, tm) * cdiv(d.layers[li].n_pad, kDwTileArea / tm);
    if (t < c) break;
    t -= c;
  }
  const int tm = plan.tile_m[li];
  const int tn_count = cdiv(d.layers[li].n_pad, kDwTileArea / tm);
  m0 = (t / tn_count) * tm;
  n0 = (t % tn_count) * (kDwTileArea / tm);
}

// Kernel 2, bf16: partial dW tile over one range of points. The tile's
// shape follows the layer (plan.tile_m: 64 x 256 for the 64-row input
// layer and the skip layer, 128 x 128 for hidden layers, 256 x 64 for a
// narrow output layer), so every warp owns a 32 x 64 block that holds
// data. Chunks of kDwChunk points stream through a ring of kDwStages
// shared-memory stages filled by cp.async while earlier chunks multiply.
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_bwd_dw_bf16(const __nv_bfloat16* __restrict__ ws, float* __restrict__ scratch,
                      MlpDesc d, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  using B16 = __nv_bfloat16;
  int li, m0, n0;
  dw_task_bf16(d, plan, li, m0, n0);
  const LayerDesc Ld = d.layers[li];
  const int tm = plan.tile_m[li], tn = kDwTileArea / tm;
  const int a_stride = tm + 8, b_stride = tn + 8;
  const int stage_elems = kDwChunk * (a_stride + b_stride);
  B16* stages = reinterpret_cast<B16*>(smem);
  const int m_valid = min(tm, Ld.k_pad - m0);
  const int n_valid = min(tn, Ld.n_pad - n0);
  const int p_begin = blockIdx.y * plan.rows_per_split;
  const int p_end = min(p_begin + plan.rows_per_split, plan.rows);
  const int chunks = (p_end - p_begin) / kDwChunk;
  const int warps_m = tm / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % warps_m, wn = warp / warps_m;  // 32 rows x 64 columns each
  const int g = lane >> 2, q = lane & 3;
  const int lj = lane >> 3, l8 = lane & 7;  // ldmatrix: matrix and row of this lane
  const bool active = wm * 32 < m_valid && wn * 64 < n_valid;

  // columns past m_valid / n_valid stay zero: no copy writes them
  for (int i = threadIdx.x; i < kDwStages * stage_elems / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(stages)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  auto issue = [&](int c) {
    if (c < chunks) {
      const int p = p_begin + c * kDwChunk;
      B16* As = stages + (c % kDwStages) * stage_elems;
      B16* Bs = As + kDwChunk * a_stride;
      const int ma = m_valid / 8, nb8 = n_valid / 8;
      for (int i = threadIdx.x; i < kDwChunk * (ma + nb8); i += blockDim.x) {
        const int pr = i / (ma + nb8), ch = i - pr * (ma + nb8);
        if (ch < ma) {
          cp_async16(As + pr * a_stride + ch * 8, x_in_col(ws, d, plan, li, m0 + ch * 8, p + pr));
        } else {
          const int cb = ch - ma;
          cp_async16(Bs + pr * b_stride + cb * 8,
                     ws + plan.dh[li] + (size_t)(p + pr) * Ld.n_pad + n0 + cb * 8);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kDwStages - 1; ++c) issue(c);

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // chunk c landed for every thread; stage (c - 1) is free
    issue(c + kDwStages - 1);
    if (!active) continue;
    const B16* As = stages + (c % kDwStages) * stage_elems;
    const B16* Bs = As + kDwChunk * a_stride;
#pragma unroll
    for (int kb = 0; kb < kDwChunk; kb += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A(m, k) = As[k][m]: matrices (m +0/+8) x (k +0/+8)
        ldsm_x4_trans(a[mt], As + (kb + (lj >> 1) * 8 + l8) * a_stride + wm * 32 + mt * 16 + (lj & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int nb = wn * 64 + np * 16;
        if (nb >= n_valid) break;
        // B(k, n) = Bs[k][n]: matrices (k +0/+8) x (n +0/+8)
        uint32_t b[4];
        ldsm_x4_trans(b, Bs + (kb + (lj & 1) * 8 + l8) * b_stride + nb + (lj >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = scratch + plan.dw_slab + (size_t)blockIdx.y * plan.total_w + Ld.w_off;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wm * 32 + mt * 16 + g + 8 * half;
        const int c = wn * 64 + nt * 8 + 2 * q;
        if (m < m_valid && c < n_valid) {
          float* o = out + (size_t)(m0 + m) * Ld.n_pad + n0 + c;
          o[0] = acc[mt][nt][2 * half];
          o[1] = acc[mt][nt][2 * half + 1];
        }
      }
}

// Kernel 2, f32: the same partial tile with FMA. Thread (tm, tn) owns rows
// 4 tm .. 4 tm + 3 and columns tn + 16 j of a 64 x 64 tile.
__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_dw_f32(const float* __restrict__ ws, float* __restrict__ scratch, MlpDesc d,
                     Plan plan) {
  __shared__ float As[kChunk][kTile32 + 1];
  __shared__ float Bs[kChunk][kTile32 + 1];
  int li, m0, n0;
  dw_task(d, kTile32, li, m0, n0);
  const LayerDesc Ld = d.layers[li];
  const int m_valid = min(kTile32, Ld.k_pad - m0);
  const int n_valid = min(kTile32, Ld.n_pad - n0);
  const int p_begin = blockIdx.y * plan.rows_per_split;
  const int p_end = min(p_begin + plan.rows_per_split, plan.rows);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int p = p_begin; p < p_end; p += kChunk) {
    for (int i = threadIdx.x; i < kChunk * kTile32; i += blockDim.x) {
      const int pr = i / kTile32, c = i - pr * kTile32;
      As[pr][c] = c < m_valid ? *x_in_col(ws, d, plan, li, m0 + c, p + pr) : 0.f;
      Bs[pr][c] = c < n_valid ? ws[plan.dh[li] + (size_t)(p + pr) * Ld.n_pad + n0 + c] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kChunk; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = scratch + plan.dw_slab + (size_t)blockIdx.y * plan.total_w + Ld.w_off;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = tm * 4 + i, c = tn + 16 * j;
      if (m < m_valid && c < n_valid) out[(size_t)(m0 + m) * Ld.n_pad + n0 + c] = acc[i][j];
    }
}

// out[y][i] = sum over slabs k in [y * group, min((y + 1) * group, count))
// of slab[k][i], in order.
__global__ void sum_slabs(const float* __restrict__ slab, float* __restrict__ out, int count,
                          int group, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  const int k0 = blockIdx.y * group;
  const int k1 = min(k0 + group, count);
  float s = 0.f;
  for (int k = k0; k < k1; ++k) s += slab[(size_t)k * len + i];
  out[(size_t)blockIdx.y * len + i] = s;
}

// ---------------------------------------------------------------------------
// Narrow path: one persistent pass, bf16, for a stack with no skip layer and
// every padded width <= kNarrowWidth (the proposal stacks, the colour head).

__host__ __device__ inline int dw_units(const LayerDesc& L) { return (L.k_pad / 16) * (L.n_pad / 8); }

// Shared memory of the one-pass kernel (bytes): both packed weight arrays,
// the biases, the CTA's running db and the warps' db partials, then the
// tile's encoding, every hidden activation and one dhc buffer.
struct NarrowSmem {
  int x0_stride, d_stride, maxw;
  size_t w, wt, bias, db, dbw, x0, h, dhc, total;
};

__host__ __device__ inline int narrow_h_stride(const LayerDesc& L) { return L.n_pad + 8; }

__host__ __device__ inline NarrowSmem narrow_smem(const MlpDesc& d) {
  NarrowSmem s;
  int total_w = 0, total_b = 0;
  s.maxw = 16;
  for (int i = 0; i < d.num_layers; ++i) {
    total_w += d.layers[i].k_pad * d.layers[i].n_pad;
    total_b += d.layers[i].n_pad;
    s.maxw = d.layers[i].n_pad > s.maxw ? d.layers[i].n_pad : s.maxw;
  }
  s.x0_stride = d.in_pad + 8;
  s.d_stride = s.maxw + 8;
  size_t off = 0;
  s.w = off;
  off += align16((size_t)total_w * 2);
  s.wt = off;
  off += align16((size_t)total_w * 2);
  s.bias = off;
  off += align16((size_t)total_b * 4);
  s.db = off;
  off += align16((size_t)total_b * 4);
  s.dbw = off;
  off += align16((size_t)8 * kNarrowWidth * 4);
  s.x0 = off;
  off += align16((size_t)kNarrowRows * s.x0_stride * 2);
  s.h = off;
  for (int i = 0; i + 1 < d.num_layers; ++i)
    off += align16((size_t)kNarrowRows * narrow_h_stride(d.layers[i]) * 2);
  s.dhc = off;
  off += align16((size_t)kNarrowRows * s.d_stride * 2);
  s.total = off;
  return s;
}

// Byte offset of hidden layer li's activation buffer.
__device__ __forceinline__ size_t narrow_h_offset(const MlpDesc& d, const NarrowSmem& s, int li) {
  size_t off = s.h;
  for (int i = 0; i < li; ++i) off += align16((size_t)kNarrowRows * narrow_h_stride(d.layers[i]) * 2);
  return off;
}

// Which stacks take the one-pass kernel.
bool narrow_ok(const MlpDesc& d, int bf16) {
  if (!bf16 || d.in_pad > kNarrowWidth) return false;
  if (d.num_freqs > 0 && d.in_dim > kNarrowDims) return false;
  int units = 0;
  for (int i = 0; i < d.num_layers; ++i) {
    const LayerDesc& L = d.layers[i];
    if (L.skip || L.k_pad > kNarrowWidth || L.n_pad > kNarrowWidth) return false;
    units += dw_units(L);
  }
  return units <= 8 * kNarrowSlots && narrow_smem(d).total <= (size_t)kSmemLimit;
}

// The accumulator of n-tiles 2 kt and 2 kt + 1 (rows g and g + 8, columns
// 2q, 2q + 1) rounded into the A fragment of k-tile kt, and stored to rows
// r0 + g, r0 + g + 8 of a shared-memory buffer.
__device__ __forceinline__ void round_store(float (&acc)[8][4], int nt_n, __nv_bfloat16* buf,
                                            int stride, int r0, uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt < nt_n) {
      const uint32_t lo = pack_bf16(acc[nt][0], acc[nt][1]);
      const uint32_t hi = pack_bf16(acc[nt][2], acc[nt][3]);
      const int c = nt * 8 + 2 * q;
      *reinterpret_cast<uint32_t*>(buf + (r0 + g) * stride + c) = lo;
      *reinterpret_cast<uint32_t*>(buf + (r0 + g + 8) * stride + c) = hi;
      a[nt >> 1][(nt & 1) * 2] = lo;
      a[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
  }
}

// One persistent pass: each CTA walks tiles blockIdx.x, + gridDim.x, ... of
// kNarrowRows points. A warp owns 16 rows of the tile across every column,
// so all 8 warps work in every layer: recompute (activations to shared
// memory, chained through registers as A fragments), the last layer's dh
// from g, then per layer from the last: relu mask, db partial, dhc to
// shared memory, one barrier, dW += x_in^T dhc into the warp's register
// tiles, dh_in = dhc W^T in registers, one barrier. dW and db end in one
// slab per CTA, summed in a fixed order by sum_slabs.
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_bwd_narrow(const float* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                     const uint4* __restrict__ w, const uint4* __restrict__ wt,
                     const float* __restrict__ bias, const float* __restrict__ freqs,
                     float* __restrict__ scratch, float* __restrict__ dx, int n, MlpDesc d,
                     Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NarrowSmem s = narrow_smem(d);
  uint4* w_s = reinterpret_cast<uint4*>(smem + s.w);
  uint4* wt_s = reinterpret_cast<uint4*>(smem + s.wt);
  float* b_s = reinterpret_cast<float*>(smem + s.bias);
  float* db_run = reinterpret_cast<float*>(smem + s.db);
  float* dbw = reinterpret_cast<float*>(smem + s.dbw);
  __nv_bfloat16* x0 = reinterpret_cast<__nv_bfloat16*>(smem + s.x0);
  __nv_bfloat16* dhc = reinterpret_cast<__nv_bfloat16*>(smem + s.dhc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int lj = lane >> 3, l8 = lane & 7;  // ldmatrix: matrix and row of this lane
  const int r0 = warp * 16;                 // this warp's rows of the tile
  const int L = d.num_layers;
  const int F = d.num_freqs, D = d.in_dim, nf = D * F;

  for (int i = threadIdx.x; i < plan.total_w / 8; i += blockDim.x) {
    w_s[i] = __ldg(w + i);
    wt_s[i] = __ldg(wt + i);
  }
  for (int i = threadIdx.x; i < plan.total_b; i += blockDim.x) {
    b_s[i] = bias[i];
    db_run[i] = 0.f;
  }
  float dw_acc[kNarrowSlots][4];
#pragma unroll
  for (int u = 0; u < kNarrowSlots; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw_acc[u][e] = 0.f;

  for (int tile = blockIdx.x; tile < plan.tiles; tile += gridDim.x) {
    const int row0 = tile * kNarrowRows;
    __syncthreads();  // the previous tile's dW products are done with x0 and h
    // encoding (or raw input) of this warp's rows, zero beyond enc_dim and n
    for (int i = lane; i < 16 * d.in_pad; i += 32) {
      const int r = i / d.in_pad, c = i - r * d.in_pad;
      const int row = row0 + r0 + r;
      float v = 0.f;
      if (row < n && c < d.enc_dim) {
        const float* xr = x + (size_t)row * D;
        if (F > 0 && c < 2 * nf) {
          const int cc = c < nf ? c : c - nf;
          const int dd = cc / F;
          const float pre = xr[dd] * freqs[cc - dd * F];  // one product
          v = c < nf ? sinf(pre) : cosf(pre);
        } else {
          v = xr[F > 0 ? c - 2 * nf : c];
        }
      }
      x0[(r0 + r) * s.x0_stride + c] = __float2bfloat16_rn(v);
    }
    __syncwarp();

    // forward recompute; the last layer only for a sigmoid head (its f32
    // pre-activation stays in acc for y(1-y))
    uint32_t a[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
      if (kt < d.in_pad / 16)
        ldsm_x4(a[kt], x0 + (r0 + (lane & 15)) * s.x0_stride + kt * 16 + (lane >> 4) * 8);
    float acc[8][4];
    for (int li = 0; li < L; ++li) {
      const LayerDesc Ld = d.layers[li];
      const bool last = li == L - 1;
      if (last && !d.out_sigmoid) break;
      warp_product(a, Ld.k_pad / 16, w_s + Ld.w_off / 8, Ld.n_pad / 16, acc);
      const int nt_n = Ld.n_pad / 8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nt_n) {
          const int c = nt * 8 + 2 * q;
          const float b0 = b_s[Ld.b_off + c], b1 = b_s[Ld.b_off + c + 1];
          acc[nt][0] += b0;
          acc[nt][1] += b1;
          acc[nt][2] += b0;
          acc[nt][3] += b1;
          if (!last) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = fmaxf(acc[nt][e], 0.f);
          }
        }
      }
      if (!last) {
        __nv_bfloat16* hl = reinterpret_cast<__nv_bfloat16*>(smem + narrow_h_offset(d, s, li));
        round_store(acc, nt_n, hl, narrow_h_stride(Ld), r0, a);
      }
    }
    __syncwarp();

    // the last layer's dh from g
    {
      const LayerDesc Ld = d.layers[L - 1];
      const int nt_n = Ld.n_pad / 8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nt_n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * q + (e & 1);
            const int row = row0 + r0 + gq + 8 * (e >> 1);
            float v = 0.f;
            if (row < n && c < d.out_dim) {
              v = __bfloat162float(g[(size_t)row * d.out_dim + c]);
              if (d.out_sigmoid) {
                const float y = 1.f / (1.f + expf(-acc[nt][e]));
                v = v * y * (1.f - y);
              }
            }
            acc[nt][e] = v;
          }
        }
      }
    }

    // walk back
    int ustart = 0;
    for (int li = 0; li < L - 1; ++li) ustart += dw_units(d.layers[li]);
    for (int li = L - 1; li >= 0; --li) {
      const LayerDesc Ld = d.layers[li];
      const int nt_n = Ld.n_pad / 8;
      if (li < L - 1) {  // mask by this layer's activation > 0
        const __nv_bfloat16* hl = reinterpret_cast<const __nv_bfloat16*>(smem + narrow_h_offset(d, s, li));
        const int hs = narrow_h_stride(Ld);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < nt_n) {
            const int c = nt * 8 + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const uint32_t hv = *reinterpret_cast<const uint32_t*>(hl + (r0 + gq + 8 * half) * hs + c);
              if (!(bf16_lo(hv) > 0.f)) acc[nt][2 * half] = 0.f;
              if (!(bf16_hi(hv) > 0.f)) acc[nt][2 * half + 1] = 0.f;
            }
          }
        }
      }
      // db partial of the warp's 16 rows: fixed-order butterfly over the 8 row lanes
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nt_n) {
          float s0 = acc[nt][0] + acc[nt][2], s1 = acc[nt][1] + acc[nt][3];
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, m);
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
          }
          if (gq == 0) {
            dbw[warp * kNarrowWidth + nt * 8 + 2 * q] = s0;
            dbw[warp * kNarrowWidth + nt * 8 + 2 * q + 1] = s1;
          }
        }
      }
      uint32_t da[4][4];
      round_store(acc, nt_n, dhc, s.d_stride, r0, da);
      __syncthreads();  // every warp's dhc and db partial
      for (int c = threadIdx.x; c < Ld.n_pad; c += blockDim.x) {
        float sum = 0.f;
        for (int k = 0; k < 8; ++k) sum += dbw[k * kNarrowWidth + c];
        db_run[Ld.b_off + c] += sum;
      }
      // dW tiles of this layer owned by this warp: dW += x_in^T dhc over the tile
      const __nv_bfloat16* xin =
          li == 0 ? x0 : reinterpret_cast<const __nv_bfloat16*>(smem + narrow_h_offset(d, s, li - 1));
      const int xs = li == 0 ? s.x0_stride : narrow_h_stride(d.layers[li - 1]);
      const int units = dw_units(Ld);
#pragma unroll
      for (int slot = 0; slot < kNarrowSlots; ++slot) {
        const int t = warp + 8 * slot - ustart;
        if (t >= 0 && t < units) {
          const int mt = t / nt_n, nt = t - mt * nt_n;
#pragma unroll 4
          for (int kb = 0; kb < kNarrowRows; kb += 16) {
            uint32_t af[4], bf[2];
            ldsm_x4_trans(af, xin + (kb + (lj >> 1) * 8 + l8) * xs + mt * 16 + (lj & 1) * 8);
            ldsm_x2_trans(bf, dhc + (kb + (lj & 1) * 8 + l8) * s.d_stride + nt * 8);
            mma_bf16(dw_acc[slot], af, bf[0], bf[1]);
          }
        }
      }
      // dh_in = dhc W^T
      if (li > 0 || !d.no_dx) warp_product(da, Ld.n_pad / 16, wt_s + Ld.w_off / 8, Ld.k_pad / 16, acc);
      if (li == 0 && !d.no_dx) {
        // dx: the encoding backward in f32 (summed over this lane's columns,
        // then over the four column lanes in a fixed order), or dx0
        if (F > 0) {
          float part[2][kNarrowDims];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int j = 0; j < kNarrowDims; ++j) part[h2][j] = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt < d.in_pad / 8) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = nt * 8 + 2 * q + (e & 1);
                const int row = row0 + r0 + gq + 8 * (e >> 1);
                if (row >= n || c >= d.enc_dim) continue;
                const float v = acc[nt][e];
                int dd;
                float term;
                if (c < 2 * nf) {
                  const int cc = c < nf ? c : c - nf;
                  dd = cc / F;
                  const float f = freqs[cc - dd * F];
                  const float pre = x[(size_t)row * D + dd] * f;
                  term = c < nf ? (v * cosf(pre)) * f : -(v * sinf(pre)) * f;
                } else {
                  dd = c - 2 * nf;
                  term = v;
                }
#pragma unroll
                for (int j = 0; j < kNarrowDims; ++j)
                  if (j == dd) part[e >> 1][j] += term;
              }
            }
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int row = row0 + r0 + gq + 8 * h2;
#pragma unroll
            for (int j = 0; j < kNarrowDims; ++j) {
              float p = part[h2][j];
              p += __shfl_xor_sync(0xffffffffu, p, 1);
              p += __shfl_xor_sync(0xffffffffu, p, 2);
              if (q == 0 && j < D && row < n) dx[(size_t)row * D + j] = p;
            }
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt < d.in_pad / 8) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = nt * 8 + 2 * q + (e & 1);
                const int row = row0 + r0 + gq + 8 * (e >> 1);
                if (row < n && c < D) {
                  const float v = acc[nt][e];
                  dx[(size_t)row * D + c] = d.dx_exact ? v : __bfloat162float(__float2bfloat16_rn(v));
                }
              }
            }
          }
        }
      }
      if (li > 0) ustart -= dw_units(d.layers[li - 1]);
      __syncthreads();  // dhc and the db partials are free for the next layer
    }
  }

  // this CTA's slabs: every dW element (the warps' tiles cover each layer)
  // and the running db
  float* dw_slab = scratch + plan.dw_slab + (size_t)blockIdx.x * plan.total_w;
  int ustart = 0;
  for (int li = 0; li < L; ++li) {
    const LayerDesc Ld = d.layers[li];
    const int nt_n = Ld.n_pad / 8, units = dw_units(Ld);
#pragma unroll
    for (int slot = 0; slot < kNarrowSlots; ++slot) {
      const int t = warp + 8 * slot - ustart;
      if (t >= 0 && t < units) {
        const int mt = t / nt_n, nt = t - mt * nt_n;
        float* o = dw_slab + Ld.w_off + (size_t)(mt * 16 + gq) * Ld.n_pad + nt * 8 + 2 * q;
        o[0] = dw_acc[slot][0];
        o[1] = dw_acc[slot][1];
        o[8 * Ld.n_pad] = dw_acc[slot][2];
        o[8 * Ld.n_pad + 1] = dw_acc[slot][3];
      }
    }
    ustart += units;
  }
  __syncthreads();
  float* db_slab = scratch + plan.db_slab + (size_t)blockIdx.x * plan.total_b;
  for (int i = threadIdx.x; i < plan.total_b; i += blockDim.x) db_slab[i] = db_run[i];
}

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
  d.dx_exact = 0;
  d.no_dx = 0;
  if (d.num_layers < 1 || d.num_layers > kMaxLayers ||
      desc_len != kDescHeader + kDescPerLayer * d.num_layers)
    return false;
  for (int i = 0; i < d.num_layers; ++i) {
    const int* l = desc + kDescHeader + kDescPerLayer * i;
    d.layers[i] = LayerDesc{l[0], l[1], l[2], l[3], l[4]};
    if (d.layers[i].n_pad > d.hid_pad && i < d.num_layers - 1) return false;
  }
  return true;
}

int num_sms(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 1;
  return v > 0 ? v : 1;
}

// The one-pass kernel's CTAs per SM on the current device at its shared
// memory (1 if the query fails). Cached by (device, shared memory): a plan is
// made several times per backward, and the grid it sets fixes the order of
// the slab sums.
int narrow_blocks_per_sm(size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> cache;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 1;
  const std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find({device, smem});
  if (hit != cache.end()) return hit->second;
  if (cudaFuncSetAttribute(fused_mlp_bwd_narrow, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_mlp_bwd_narrow, kThreads, smem) !=
          cudaSuccess ||
      blocks < 1)
    return 1;
  cache[{device, smem}] = blocks;
  return blocks;
}

// Rows of a layer's bf16 dW tiles: the shape (128 x 128, 64 x 256 or 256 x
// 64) with the fewest tiles times 16-column pairs in the busiest warp, the
// square one on a tie (fewer rereads of the workspace).
int dw_tile_m(const LayerDesc& L) {
  int best = 128;
  long long best_cost = -1;
  const int shapes[3] = {128, 64, 256};
  for (int tm : shapes) {
    const int tn = kDwTileArea / tm;
    const int pairs = cdiv(L.n_pad < tn ? L.n_pad : tn, 16);
    const long long cost = (long long)cdiv(L.k_pad, tm) * cdiv(L.n_pad, tn) * (pairs < 4 ? pairs : 4);
    if (best_cost < 0 || cost < best_cost) {
      best = tm;
      best_cost = cost;
    }
  }
  return best;
}

Plan make_plan(const MlpDesc& d, int n, int bf16, int num_sms) {
  Plan p = {};
  p.total_w = 0;
  p.total_b = 0;
  for (int i = 0; i < d.num_layers; ++i) {
    p.total_w += d.layers[i].k_pad * d.layers[i].n_pad;
    p.total_b += d.layers[i].n_pad;
  }
  p.narrow = narrow_ok(d, bf16);
  if (p.narrow) {
    // persistent CTAs, as many as fit on the card at once; the tiles each
    // takes depend only on the grid, so the sums are the same every run
    p.smem = narrow_smem(d).total;
    p.tiles = cdiv(n, kNarrowRows);
    const int fit = num_sms * narrow_blocks_per_sm(p.smem);
    p.grid = p.tiles < fit ? p.tiles : fit;
    p.ws_elems = 0;
    p.dw_slab = 0;
    p.db_slab = (long long)p.grid * p.total_w;
    p.scratch_floats = p.db_slab + (long long)p.grid * p.total_b;
    return p;
  }
  p.smem = smem_layout(d, bf16 ? 2 : 4).total;
  p.rows = cdiv(n, kBM) * kBM;
  p.walk_blocks = p.rows / kBM;
  p.tasks = 0;
  p.dw_smem = 0;
  for (int i = 0; i < d.num_layers; ++i) {
    if (!bf16) {
      p.tasks += layer_tiles(d.layers[i], kTile32);
      continue;
    }
    p.tile_m[i] = dw_tile_m(d.layers[i]);
    const int tm = p.tile_m[i], tn = kDwTileArea / tm;
    p.tasks += cdiv(d.layers[i].k_pad, tm) * cdiv(d.layers[i].n_pad, tn);
    const size_t smem = (size_t)kDwStages * kDwChunk * (tm + 8 + tn + 8) * 2;
    p.dw_smem = smem > p.dw_smem ? smem : p.dw_smem;
  }
  // about four CTAs per SM over all tiles and point ranges
  int splits = cdiv(4 * num_sms, p.tasks);
  const int chunk = bf16 ? kDwChunk : kChunk;
  const int max_splits = p.rows / chunk;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  p.rows_per_split = cdiv(cdiv(p.rows, splits), chunk) * chunk;
  p.splits = cdiv(p.rows, p.rows_per_split);
  long long off = 0;
  p.x0 = off;
  off += (long long)p.rows * d.in_pad;
  for (int i = 0; i < d.num_layers; ++i) {
    p.act[i] = off;
    if (i < d.num_layers - 1) off += (long long)p.rows * d.layers[i].n_pad;
  }
  for (int i = 0; i < d.num_layers; ++i) {
    p.dh[i] = off;
    off += (long long)p.rows * d.layers[i].n_pad;
  }
  p.ws_elems = off;
  p.dw_slab = 0;
  p.db_slab = p.dw_slab + (long long)p.splits * p.total_w;
  p.db_tmp = p.db_slab + (long long)p.walk_blocks * p.total_b;
  p.scratch_floats = p.db_tmp + (long long)cdiv(p.walk_blocks, kSumGroup) * p.total_b;
  return p;
}

// The narrow path: the one-pass kernel, then the fixed-order sums of its
// per-CTA dW and db slabs.
cudaError_t launch_narrow(const float* x, const __nv_bfloat16* g, const void* w, const void* wt,
                          const float* bias, const float* freqs, float* scratch, float* dx,
                          float* dw, float* db, int n, const MlpDesc& d, const Plan& plan,
                          cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bwd_narrow,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_narrow<<<plan.grid, kThreads, plan.smem, s>>>(
      x, g, static_cast<const uint4*>(w), static_cast<const uint4*>(wt), bias, freqs, scratch, dx, n,
      d, plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slabs<<<dim3(cdiv(plan.total_w, 256), 1), 256, 0, s>>>(scratch + plan.dw_slab, dw, plan.grid,
                                                             plan.grid, plan.total_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slabs<<<dim3(cdiv(plan.total_b, 256), 1), 256, 0, s>>>(scratch + plan.db_slab, db, plan.grid,
                                                             plan.grid, plan.total_b);
  return cudaGetLastError();
}

// One backward on stream s, down the path the plan chose.
template <typename T>
cudaError_t launch_all(const float* x, const T* g, const void* w, const void* wt,
                       const float* bias, const float* freqs, T* ws, float* scratch, float* dx,
                       float* dw, float* db, int n, const MlpDesc& d, const Plan& plan,
                       cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (plan.narrow) return launch_narrow(x, g, w, wt, bias, freqs, scratch, dx, dw, db, n, d, plan, s);
  }
  cudaError_t err;
  const dim3 grid(plan.tasks, plan.splits);
  if constexpr (sizeof(T) == 2) {
    err = cudaFuncSetAttribute(fused_mlp_bwd_walk_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.smem);
    if (err != cudaSuccess) return err;
    fused_mlp_bwd_walk_bf16<<<plan.walk_blocks, kWalkThreads, plan.smem, s>>>(
        x, g, static_cast<const uint4*>(w), static_cast<const uint4*>(wt), bias, freqs, ws, scratch,
        dx, n, d, plan);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fused_mlp_bwd_dw_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.dw_smem);
    if (err != cudaSuccess) return err;
    fused_mlp_bwd_dw_bf16<<<grid, kThreads, plan.dw_smem, s>>>(ws, scratch, d, plan);
  } else {
    err = cudaFuncSetAttribute(fused_mlp_bwd_walk_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.smem);
    if (err != cudaSuccess) return err;
    fused_mlp_bwd_walk_f32<<<plan.walk_blocks, kThreads, plan.smem, s>>>(
        x, g, w, wt, bias, freqs, ws, scratch, dx, n, d, plan);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    fused_mlp_bwd_dw_f32<<<grid, kThreads, 0, s>>>(ws, scratch, d, plan);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slabs<<<dim3(cdiv(plan.total_w, 256), 1), 256, 0, s>>>(scratch + plan.dw_slab, dw,
                                                             plan.splits, plan.splits,
                                                             plan.total_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int groups = cdiv(plan.walk_blocks, kSumGroup);
  sum_slabs<<<dim3(cdiv(plan.total_b, 256), groups), 256, 0, s>>>(
      scratch + plan.db_slab, scratch + plan.db_tmp, plan.walk_blocks, kSumGroup, plan.total_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slabs<<<dim3(cdiv(plan.total_b, 256), 1), 256, 0, s>>>(scratch + plan.db_tmp, db, groups,
                                                             groups, plan.total_b);
  return cudaGetLastError();
}

}  // namespace

// Sizes the caller allocates: out[0] workspace elements (compute dtype; 0
// on the narrow path), out[1] scratch floats, out[2] dynamic shared memory
// of the walk or one-pass kernel (bytes), out[3] 1 for the narrow path.
// Returns 0, or cudaErrorInvalidValue for a bad descriptor.
extern "C" int fused_mlp_bwd_sizes(const int* desc, int desc_len, int n, int compute_bf16,
                                   int device, long long* out) {
  MlpDesc d;
  if (!parse_desc(desc, desc_len, d) || n <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan plan = make_plan(d, n, compute_bf16, num_sms(device));
  out[0] = plan.ws_elems;
  out[1] = plan.scratch_floats;
  out[2] = (long long)plan.smem;
  out[3] = plan.narrow;
  return 0;
}

// One backward: the walk, dW and the two sums, on `stream`. x [n, in_dim]
// f32, g [n, out_dim] in the compute dtype; w and wt the packed weights and
// their transposes (same offsets), bias the packed f32 biases, freqs the
// encoding table. Outputs: dx [n, in_dim] f32, dw [total_w] f32 in the
// padded weight layout (row-major [k_pad, n_pad] per layer at w_off), db
// [total_b] f32 at b_off. Returns the cudaError_t of the launches.
extern "C" int fused_mlp_bwd(const void* x, const void* g, const void* w, const void* wt,
                             const void* bias, const void* freqs, void* ws, void* scratch,
                             void* dx, void* dw, void* db, int n, const int* desc, int desc_len,
                             int compute_bf16, int device, void* stream) {
  MlpDesc d;
  if (!parse_desc(desc, desc_len, d) || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan plan = make_plan(d, n, compute_bf16, num_sms(device));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    err = launch_all<__nv_bfloat16>(
        static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(g), w, wt,
        static_cast<const float*>(bias), static_cast<const float*>(freqs),
        static_cast<__nv_bfloat16*>(ws), static_cast<float*>(scratch),
        static_cast<float*>(dx), static_cast<float*>(dw), static_cast<float*>(db), n, d, plan, s);
  } else {
    err = launch_all<float>(
        static_cast<const float*>(x), static_cast<const float*>(g), w, wt,
        static_cast<const float*>(bias), static_cast<const float*>(freqs),
        static_cast<float*>(ws), static_cast<float*>(scratch), static_cast<float*>(dx),
        static_cast<float*>(dw), static_cast<float*>(db), n, d, plan, s);
  }
  return (int)err;
}
