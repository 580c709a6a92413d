// Exact-f32 building blocks shared by the fused-MLP forward and backward
// (fused_mlp_fwd.cu, fused_mlp_bwd.cu): a register-tiled product on the
// CUDA cores and the ring of weight K-slices that feeds it.
//
// Every product is an FMA chain in f32 (fmaf), no TF32 and no tensor-core
// instruction, as the TPU kernels' Precision.HIGHEST f32 path
// (nerfstudio_thermal_tpu/ops/pallas/kernel_precision.py). Each output sums
// its k terms in one fixed order (k = 0, 1, ...), so the results are the
// same bits from run to run.
//
// Layout. A CTA of kF32Threads threads takes kF32Rows points. Activations
// sit in shared memory k-major: row k holds value k of the tile's points,
// kF32Stride floats apart (4 floats of padding, so that a column's stores in
// an epilogue spread over the banks). A product C[128 points, N] = A B takes
// its A rows from one or two such buffers (x0, then h) and B, rows k of a
// row-major matrix (the packed weights or their transposes), in slices of
// kF32SliceK rows that cp.async copies into a ring of kF32Stages slots: the
// next slice loads while the threads multiply one. Thread (ty, tx) holds a
// TM x TN register tile: points ty*4 + {0..3} (+ 64 for TM 8) and columns
// tx*4 + {0..3} (+ NT/2 for TN 8), so that its A values at one k are one or
// two float4 loads and its B values one or two more; a warp's 4 ty and 8 tx
// read 64 and 128 contiguous bytes (no bank conflict). The tile shape
// follows the product's width N (F32Tile): 8 x 8 up to 256 columns, 8 x 4
// up to 128, 4 x 4 up to 64, so that every thread holds outputs; a warp
// whose columns all lie past N skips the products.
//
// Wider products. A product more than kF32MaxWidth columns wide runs as
// column passes of at most kF32MaxWidth (f32_pass_col0): columns 256 and
// on first, columns [0, 256) last. A layer whose output overwrites the
// activations it reads keeps its earlier passes in spill rows, (width -
// 256) k rows that follow the activation buffer's own, until its last pass
// has read them; the last pass writes rows [0, 256) and copies the spill
// in behind them (f32_copy_spill). So the only limit on a stack's widths
// is its shared memory. The kernels are built twice, kWide true for a
// stack with such a product and false for the rest, whose one pass a
// product then folds away (left in, the pass loop slowed the 64-wide
// stacks and added register spills to the walk).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32Rows = 128;               // points per CTA
constexpr int kF32Threads = 512;            // 16 warps
constexpr int kF32Stride = kF32Rows + 4;    // floats between two k rows of an activation buffer
constexpr int kF32SliceK = 16;              // k rows per weight slice
constexpr int kF32Stages = 2;               // ring slots
constexpr int kF32MaxWidth = 256;           // widest column pass of a product
constexpr int kF32Slot = kF32SliceK * kF32MaxWidth;  // floats per ring slot

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Columns a product of width ncols is tiled for (F32Tile<TM, TN>::NT).
__host__ __device__ inline int f32_tile_width(int ncols) { return ncols > 128 ? 256 : (ncols > 64 ? 128 : 64); }

// Column passes of a product n columns wide, and the first column of the
// q-th pass it runs: column blocks 1, 2, ..., then block 0.
__host__ __device__ inline int f32_passes(int n) { return (n + kF32MaxWidth - 1) / kF32MaxWidth; }
__host__ __device__ inline int f32_pass_col0(int n, int q) { return (q + 1) % f32_passes(n) * kF32MaxWidth; }
__host__ __device__ inline int f32_pass_cols(int n, int col0) {
  return n - col0 < kF32MaxWidth ? n - col0 : kF32MaxWidth;
}
// k rows of the spill buffer of layers up to `width` wide.
__host__ __device__ inline int f32_spill_rows(int width) { return width > kF32MaxWidth ? width - kF32MaxWidth : 0; }
// The same in a kernel built for stacks with (kWide) or without a product
// wider than 256: one pass of every column for !kWide.
template <bool kWide>
__device__ __forceinline__ int f32_npasses(int n) {
  return kWide ? f32_passes(n) : 1;
}
template <bool kWide>
__device__ __forceinline__ int f32_col0(int n, int q) {
  return kWide ? f32_pass_col0(n, q) : 0;
}
template <bool kWide>
__device__ __forceinline__ int f32_cols(int n, int c0) {
  return kWide ? f32_pass_cols(n, c0) : n;
}

// Thread (ty, tx)'s register tile of a 128-point product NT columns wide.
template <int TM, int TN>
struct F32Tile {
  static constexpr int GY = kF32Rows / TM;     // thread rows
  static constexpr int GX = kF32Threads / GY;  // thread columns
  static constexpr int NT = GX * TN;           // columns covered
  int ty, tx, warp_col0;

  __device__ F32Tile() {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    ty = (w % (GY / 4)) * 4 + (l >> 3);
    tx = (w / (GY / 4)) * 8 + (l & 7);
    warp_col0 = (w / (GY / 4)) * 32;
  }
  __device__ int point(int i) const { return ty * 4 + (i & 3) + (i >> 2) * 64; }
  __device__ int col(int j) const { return tx * 4 + (j & 3) + (j >> 2) * (NT / 2); }
  // whether any column of this warp lies below ncols
  __device__ bool active(int ncols) const { return warp_col0 < ncols; }
};

// The B operand of one product: rows [0, k) of a row-major matrix m with
// ld columns, its columns [col0, col0 + ncols) (ncols and k multiples of
// 16, ncols <= kF32MaxWidth: one column pass).
struct F32Operand {
  const float* m;
  int ld, col0, ncols, k;
};

// The weight slices of a sequence of products, in the order the CTA
// multiplies them; seq(i) gives product i's operand, count products in all.
// A slice lands in its slot as [kF32SliceK][NT] (NT = f32_tile_width of
// its product), columns past ncols left as they were (no output reads
// them). issue() keeps one slice in flight ahead of the one being
// multiplied, across product boundaries.
template <class Seq>
struct F32Stream {
  Seq seq;
  float* ring;
  int count, prod, slice, slices, issued, consumed;
  F32Operand op;

  __device__ void init(const Seq& s, float* ring_, int count_) {
    seq = s;
    ring = ring_;
    count = count_;
    prod = slice = issued = consumed = 0;
    shape();
  }
  __device__ void shape() {
    if (prod < count) {
      op = seq(prod);
      slices = op.k / kF32SliceK;
    }
  }
  // Every thread: copy the next slice (if any) into its slot and commit one
  // cp.async group.
  __device__ void issue() {
    if (prod < count) {
      float* dst = ring + (issued % kF32Stages) * kF32Slot;
      const int nt = f32_tile_width(op.ncols);
      const int per_row = op.ncols / 4;
      const float* src = op.m + (size_t)slice * kF32SliceK * op.ld + op.col0;
      for (int i = threadIdx.x; i < kF32SliceK * per_row; i += blockDim.x) {
        const int r = i / per_row, c = (i - r * per_row) * 4;
        cp_async16(dst + r * nt + c, src + (size_t)r * op.ld + c);
      }
      ++issued;
      if (++slice == slices) {
        slice = 0;
        ++prod;
        shape();
      }
    }
    cp_async_commit();
  }
  // Wait for the next slice (every thread of the block calls it), start the
  // one after it, and return the slot.
  __device__ const float* next() {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // the slice landed for every thread; the slot read before it is free
    issue();
    return ring + (consumed++ % kF32Stages) * kF32Slot;
  }
};

// acc = A[128, k] B on the CUDA cores: A's rows k < k0 from a0, the rest
// from a1 (both k-major, row stride kF32Stride; k0 a multiple of
// kF32SliceK), B slice by slice from the stream (the product's ncols
// columns). Ends with a barrier, after which the epilogue may overwrite a1
// in place. Every thread of the block calls it, in the stream's order.
// The slice's 16 k steps are unrolled whole.
template <int TM, int TN, class Seq>
__device__ __forceinline__ void f32_product(const F32Tile<TM, TN>& t, const float* a0, int k0, const float* a1,
                                            int k, int ncols, F32Stream<Seq>& st, float (&acc)[TM][TN]) {
  constexpr int NT = F32Tile<TM, TN>::NT;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const bool active = t.active(ncols);
  for (int kb = 0; kb < k; kb += kF32SliceK) {
    const float* slot = st.next();
    if (!active) continue;
    const float* ap = (kb < k0 ? a0 + kb * kF32Stride : a1 + (kb - k0) * kF32Stride) + t.ty * 4;
    const float* bp = slot + t.tx * 4;
#pragma unroll
    for (int kk = 0; kk < kF32SliceK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(ap + kk * kF32Stride + 64 * h);
        av[4 * h] = v.x;
        av[4 * h + 1] = v.y;
        av[4 * h + 2] = v.z;
        av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(bp + kk * NT + (NT / 2) * h);
        bv[4 * h] = v.x;
        bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z;
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();  // every thread is done reading a0 / a1
}

// Runs f(F32Tile<TM, TN>()) with the tile shape of a product ncols wide.
template <class F>
__device__ __forceinline__ void with_f32_tile(int ncols, F f) {
  switch (f32_tile_width(ncols)) {
    case 256:
      f(F32Tile<8, 8>());
      break;
    case 128:
      f(F32Tile<8, 4>());
      break;
    default:
      f(F32Tile<4, 4>());
      break;
  }
}

// Stores v[4] (points p .. p + 3 of column c) into a k-major buffer.
__device__ __forceinline__ void store_points4(float* buf, int c, int p, float v0, float v1, float v2, float v3) {
  *reinterpret_cast<float4*>(buf + c * kF32Stride + p) = make_float4(v0, v1, v2, v3);
}

// The k row of h that holds column c of a column pass starting at c0:
// row c in place, or for a pass past column 256 of a product that still
// reads h, the spill rows after h's own `rows`.
__device__ __forceinline__ int f32_out_row(int c, int c0, bool spilled, int rows) {
  return spilled ? rows + c0 - kF32MaxWidth + c : c0 + c;
}

// After the last pass of a layer n columns wide that kept its earlier
// passes in the spill rows (after h's own `rows`): the spill into h rows
// [256, n). Every thread calls it; the next product's first barrier
// orders it before any read.
__device__ __forceinline__ void f32_copy_spill(float* h, int rows, int n) {
  const int vecs = f32_spill_rows(n) * (kF32Stride / 4);
  float4* dst = reinterpret_cast<float4*>(h + kF32MaxWidth * kF32Stride);
  const float4* src = reinterpret_cast<const float4*>(h + rows * kF32Stride);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) dst[i] = src[i];
}

}  // namespace
