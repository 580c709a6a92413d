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
// a point (x, g, dx), so it is bound by operations.
//
// Design. The TPU kernel runs its grid in order and sums dW/db with += into
// VMEM-resident outputs. Here blocks run in parallel, and the walk needs
// every layer's activations (7 x 256 bf16 = 3.5 KB a point), so 128 points
// do not fit in shared memory beside the gradient buffers. The kernel
// therefore streams (the schedule of the TPU's _fwd_save/_bwd_saved pair):
//   1. walk (one CTA of 8 warps per 64 points): encoding into shared memory;
//      forward recompute through two shared-memory buffers, writing the
//      encoding and every hidden activation to a workspace in device
//      memory; then the walk back, layer by layer, with dhc kept in shared
//      memory and written to the workspace; per-CTA db partials (column sums
//      in a fixed order); the encoding backward gives dx.
//   2. dW (one CTA of 8 warps per 128 x 128 tile of a layer's dW and per
//      range of points): dW_tile = sum over points of x_in^T dhc, read from
//      the workspace through shared memory with ldmatrix.trans, into a
//      partial slab per range.
//   3. fixed-order sums of the partial slabs give dW and db. No atomics:
//      the result does not change from run to run.
// Products run as bf16 mma.sync m16n8k16 with f32 accumulation; the f32
// compute path is a plain FMA loop on the CUDA cores (no TF32).
// The workspace costs about 7.3 KB a point of device memory (1.9 GB at
// N = 262,144) and as much traffic each way; that, mma.sync in place of
// wgmma and the missing load/compute overlap are what this first design
// gives up.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: the top frequency reaches
// ~3217 rad per unit of x, where __sinf/__cosf lose all accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 64;         // points per CTA, walk kernel
constexpr int kTile16 = 128;    // dW tile edge, bf16 path
constexpr int kTile32 = 64;     // dW tile edge, f32 path
constexpr int kChunk = 32;      // points per shared-memory stage, dW kernel
constexpr int kSumGroup = 64;   // slabs summed per block in the first stage
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
  int rows;            // points padded to a multiple of kBM
  int walk_blocks;     // rows / kBM
  int tasks;           // dW tiles over all layers
  int splits;          // point ranges per dW tile
  int rows_per_split;  // multiple of kChunk
  int total_w;         // sum k_pad * n_pad
  int total_b;         // sum n_pad
  long long ws_elems;
  long long x0;
  long long act[kMaxLayers];  // hidden outputs, layers 0..L-2: [rows, n_pad]
  long long dh[kMaxLayers];   // dhc of every layer: [rows, n_pad]
  long long dw_slab;          // [splits, total_w]
  long long db_slab;          // [walk_blocks, total_b]
  long long db_tmp;           // [ceil(walk_blocks / kSumGroup), total_b]
  long long scratch_floats;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int layer_tiles(const LayerDesc& L, int tile) {
  return cdiv(L.k_pad, tile) * cdiv(L.n_pad, tile);
}

Plan make_plan(const MlpDesc& d, int n, int bf16, int num_sms) {
  Plan p;
  p.rows = cdiv(n, kBM) * kBM;
  p.walk_blocks = p.rows / kBM;
  const int tile = bf16 ? kTile16 : kTile32;
  p.tasks = 0;
  p.total_w = 0;
  p.total_b = 0;
  for (int i = 0; i < d.num_layers; ++i) {
    p.tasks += layer_tiles(d.layers[i], tile);
    p.total_w += d.layers[i].k_pad * d.layers[i].n_pad;
    p.total_b += d.layers[i].n_pad;
  }
  // about four CTAs per SM over all tiles and point ranges
  int splits = cdiv(4 * num_sms, p.tasks);
  const int max_splits = p.rows / kChunk;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  p.rows_per_split = cdiv(cdiv(p.rows, splits), kChunk) * kChunk;
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

// Shared memory of the walk kernel (bytes), for element size es (2 or 4).
struct Smem {
  int x0_stride, h_stride, f_stride, d_stride, o_stride, words;
  size_t x0, ha, hb, dhc, dhf, dx0, fpre, mask, total;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline Smem smem_layout(const MlpDesc& d, int es) {
  Smem s;
  const int pad = es == 2 ? 8 : 1;
  const int out_pad = d.layers[d.num_layers - 1].n_pad;
  const int wid = d.hid_pad > out_pad ? d.hid_pad : out_pad;  // widest dh
  s.x0_stride = d.in_pad + pad;
  s.h_stride = wid + pad;
  s.f_stride = wid + 4;
  s.d_stride = d.in_pad + 4;
  s.o_stride = out_pad + 4;
  size_t off = 0;
  s.x0 = off;
  off += align16((size_t)kBM * s.x0_stride * es);
  const size_t h_bytes = align16((size_t)kBM * s.h_stride * es);
  // forward: two activation buffers; walk: dhc (compute dtype) and dhf (f32)
  // in the same bytes
  s.ha = off;
  s.hb = off + h_bytes;
  s.dhc = off;
  s.dhf = off + h_bytes;
  const size_t fwd_end = s.hb + h_bytes;
  const size_t walk_end = s.dhf + align16((size_t)kBM * s.f_stride * 4);
  off = fwd_end > walk_end ? fwd_end : walk_end;
  s.dx0 = off;
  off += align16((size_t)kBM * s.d_stride * 4);
  s.fpre = off;
  off += align16((size_t)kBM * s.o_stride * 4);
  // relu masks of the hidden layers, one bit per activation > 0
  s.words = (wid + 31) / 32;
  s.mask = off;
  off += align16((size_t)(d.num_layers > 1 ? d.num_layers - 1 : 1) * kBM * s.words * 4);
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// C[kBM, n_cols] = A[kBM, K] B[K, n_cols] on the tensor cores. A is read
// from shared memory in two K segments (kt0 16-wide tiles of src0, then
// src1); B is packed in mma B-fragment order (see fused_mlp.py
// _fragment_index). Warps: 2 along M (32 rows) x 4 along N (64 columns);
// epi(r, c, v) receives every output element.
template <class Epi>
__device__ __forceinline__ void product_bf16(const __nv_bfloat16* src0, int stride0, int kt0,
                                             const __nv_bfloat16* src1, int stride1,
                                             int kt_total, const uint4* __restrict__ wl,
                                             int n_cols, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, q = lane & 3;
  const int np_total = n_cols / 16;
  for (int nb = 0; nb < n_cols; nb += 256) {
    const int p0 = (nb + wn * 64) / 16;
    if (p0 >= np_total) continue;  // warp-uniform
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int kt = 0; kt < kt_total; ++kt) {
      const __nv_bfloat16* src;
      int stride, kc;
      if (kt < kt0) {
        src = src0; stride = stride0; kc = kt * 16;
      } else {
        src = src1; stride = stride1; kc = (kt - kt0) * 16;
      }
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        const uint32_t* p = reinterpret_cast<const uint32_t*>(src + r * stride + kc) + q;
        a[mt][0] = p[0];
        a[mt][1] = p[4 * stride];
        a[mt][2] = p[4];
        a[mt][3] = p[4 * stride + 4];
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int p = p0 + pp;
        if (p < np_total) {
          const uint4 bv = __ldg(wl + ((size_t)kt * np_total + p) * 32 + lane);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * pp], a[mt], bv.x, bv.y);
            mma_bf16(acc[mt][2 * pp + 1], a[mt], bv.z, bv.w);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = p0 * 16 + nt * 8 + 2 * q;
      if (col >= n_cols) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 32 + mt * 16 + g + 8 * half;
          epi(r, col, acc[mt][nt][2 * half]);
          epi(r, col + 1, acc[mt][nt][2 * half + 1]);
        }
    }
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

template <typename T, class Epi>
__device__ __forceinline__ void product(const T* src0, int stride0, int k0, const T* src1,
                                        int stride1, int k_total, const void* wl, int n_cols,
                                        Epi epi) {
  if constexpr (sizeof(T) == 2) {
    product_bf16(src0, stride0, k0 / 16, src1, stride1, k_total / 16,
                 static_cast<const uint4*>(wl), n_cols, epi);
  } else {
    product_f32(src0, stride0, k0, src1, stride1, k_total, static_cast<const float*>(wl),
                n_cols, epi);
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

// Kernel 1: recompute, walk back, dx and per-CTA db partials.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_walk(const float* __restrict__ x, const T* __restrict__ g,
                   const void* __restrict__ w, const void* __restrict__ wt,
                   const float* __restrict__ bias, const float* __restrict__ freqs,
                   T* ws, float* __restrict__ scratch, float* __restrict__ dx, int n,
                   MlpDesc d, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = smem_layout(d, sizeof(T));
  T* x0 = reinterpret_cast<T*>(smem + s.x0);
  T* ha = reinterpret_cast<T*>(smem + s.ha);
  T* hb = reinterpret_cast<T*>(smem + s.hb);
  T* dhc = reinterpret_cast<T*>(smem + s.dhc);
  float* dhf = reinterpret_cast<float*>(smem + s.dhf);
  float* dx0 = reinterpret_cast<float*>(smem + s.dx0);
  float* fpre = reinterpret_cast<float*>(smem + s.fpre);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + s.mask);
  float* dbp = scratch + plan.db_slab + (size_t)blockIdx.x * plan.total_b;
  const int row0 = blockIdx.x * kBM;
  const int L = d.num_layers;
  const int F = d.num_freqs, D = d.in_dim, nf = D * F;
  const size_t es = sizeof(T);  // element width: the wl offsets are in elements

  // encoding (or raw input) of the block, zero beyond enc_dim and beyond n
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
    x0[r * s.x0_stride + c] = tv;
    ws[plan.x0 + (size_t)row * d.in_pad + c] = tv;
  }
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
    const T* hin = flip ? hb : ha;
    T* hout = flip ? ha : hb;
    const float* bl = bias + Ld.b_off;
    const void* wl = static_cast<const unsigned char*>(w) + (size_t)Ld.w_off * es;
    if (!last) {
      product<T>(x0, s.x0_stride, k0, hin, s.h_stride, Ld.k_pad, wl, Ld.n_pad,
                 [&](int r, int c, float v) {
                   hout[r * s.h_stride + c] = from_f32<T>(fmaxf(v + bl[c], 0.f));
                 });
    } else {
      product<T>(x0, s.x0_stride, k0, hin, s.h_stride, Ld.k_pad, wl, Ld.n_pad,
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
    T* dst = ws + plan.dh[L - 1] + (size_t)row0 * Ld.n_pad;
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
      const T tv = from_f32<T>(v);
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
    const void* wl = static_cast<const unsigned char*>(wt) + (size_t)Ld.w_off * es;
    product<T>(dhc, s.h_stride, Ld.n_pad, dhc, s.h_stride, Ld.n_pad, wl, Ld.k_pad,
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
    T* dst = ws + plan.dh[li - 1] + (size_t)row0 * P.n_pad;
    for (int i = threadIdx.x; i < kBM * P.n_pad; i += blockDim.x) {
      const int r = i / P.n_pad, c = i - r * P.n_pad;
      const float keep = (ml[r * s.words + (c >> 5)] >> (c & 31)) & 1u ? 1.f : 0.f;
      const float v = dhf[r * s.f_stride + c] * keep;
      const T tv = from_f32<T>(v);
      dhf[r * s.f_stride + c] = v;
      dhc[r * s.h_stride + c] = tv;
      dst[i] = tv;
    }
    __syncthreads();
    column_sums(dhf, s.f_stride, P.n_pad, dbp + P.b_off);
    __syncthreads();
  }

  // dx: the encoding backward in f32, or dx0 rounded to the compute dtype
  if (d.no_dx) return;
  for (int i = threadIdx.x; i < kBM * D; i += blockDim.x) {
    const int r = i / D, dd = i - r * D;
    const int row = row0 + r;
    if (row >= n) continue;
    const float* d0 = dx0 + r * s.d_stride;
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

// Kernel 2, bf16: partial dW tile over one range of points.
__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_dw_bf16(const __nv_bfloat16* __restrict__ ws, float* __restrict__ scratch,
                      MlpDesc d, Plan plan) {
  __shared__ __align__(16) __nv_bfloat16 As[kChunk][kTile16 + 8];
  __shared__ __align__(16) __nv_bfloat16 Bs[kChunk][kTile16 + 8];
  int li, m0, n0;
  dw_task(d, kTile16, li, m0, n0);
  const LayerDesc Ld = d.layers[li];
  const int m_valid = min(kTile16, Ld.k_pad - m0);
  const int n_valid = min(kTile16, Ld.n_pad - n0);
  const int p_begin = blockIdx.y * plan.rows_per_split;
  const int p_end = min(p_begin + plan.rows_per_split, plan.rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;  // 4 along M (32 rows), 2 along N (64 columns)
  const int g = lane >> 2, q = lane & 3;
  const int lj = lane >> 3, li8 = lane & 7;  // ldmatrix: matrix and row of this lane
  const bool active = wm * 32 < m_valid && wn * 64 < n_valid;
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int p = p_begin; p < p_end; p += kChunk) {
    for (int i = threadIdx.x; i < kChunk * (kTile16 / 8); i += blockDim.x) {
      const int pr = i / (kTile16 / 8), ch = i - pr * (kTile16 / 8);
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (ch * 8 < m_valid) {
        va = *reinterpret_cast<const uint4*>(x_in_col(ws, d, plan, li, m0 + ch * 8, p + pr));
      }
      if (ch * 8 < n_valid) {
        vb = *reinterpret_cast<const uint4*>(ws + plan.dh[li] + (size_t)(p + pr) * Ld.n_pad + n0 + ch * 8);
      }
      *reinterpret_cast<uint4*>(&As[pr][ch * 8]) = va;
      *reinterpret_cast<uint4*>(&Bs[pr][ch * 8]) = vb;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kb = 0; kb < kChunk; kb += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A(m, k) = As[k][m]: matrices (m +0/+8) x (k +0/+8)
          const int mb = wm * 32 + mt * 16;
          ldsm_x4_trans(a[mt], &As[kb + (lj >> 1) * 8 + li8][mb + (lj & 1) * 8]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          // B(k, n) = Bs[k][n]: matrices (k +0/+8) x (n +0/+8)
          const int nb = wn * 64 + np * 16;
          uint32_t b[4];
          ldsm_x4_trans(b, &Bs[kb + (lj & 1) * 8 + li8][nb + (lj >> 1) * 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }
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

template <typename T>
cudaError_t launch_all(const float* x, const T* g, const void* w, const void* wt,
                       const float* bias, const float* freqs, T* ws, float* scratch, float* dx,
                       float* dw, float* db, int n, const MlpDesc& d, const Plan& plan,
                       cudaStream_t s) {
  const Smem sm = smem_layout(d, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bwd_walk<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sm.total);
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_walk<T><<<plan.walk_blocks, kThreads, sm.total, s>>>(
      x, g, w, wt, bias, freqs, ws, scratch, dx, n, d, plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(plan.tasks, plan.splits);
  if constexpr (sizeof(T) == 2) {
    fused_mlp_bwd_dw_bf16<<<grid, kThreads, 0, s>>>(ws, scratch, d, plan);
  } else {
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

// Sizes the caller allocates: out[0] workspace elements (compute dtype),
// out[1] scratch floats, out[2] dynamic shared memory of the walk kernel
// (bytes). Returns 0, or cudaErrorInvalidValue for a bad descriptor.
extern "C" int fused_mlp_bwd_sizes(const int* desc, int desc_len, int n, int compute_bf16,
                                   int device, long long* out) {
  MlpDesc d;
  if (!parse_desc(desc, desc_len, d) || n <= 0) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(d, n, compute_bf16, num_sms(device));
  out[0] = plan.ws_elems;
  out[1] = plan.scratch_floats;
  out[2] = (long long)smem_layout(d, compute_bf16 ? 2 : 4).total;
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
