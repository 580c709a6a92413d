// Fused-MLP forward for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes). Wrapper, plain PyTorch version and the weight packing
// live in nerfstudio_thermal_torch/ops/cuda/fused_mlp.py.
//
// Replaces the TPU kernel nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:
// _fwd_kernel (entry point fused_mlp). Function: per point, an optional NeRF
// frequency encoding [sin(x_d * f_k), cos(x_d * f_k), x] computed in f32 and
// rounded to the compute dtype, then relu hidden layers; a skip layer takes
// concat([x0, h]) with x0 the encoded input; the last layer applies none or
// sigmoid. Each layer adds its bias (rounded to the compute dtype, then
// widened to f32) to an f32 accumulator, applies the activation in f32 and
// rounds to the compute dtype. Output in the compute dtype.
//
// What bounds it: the base field of thermal-nerfacto-tpu (8 x 256, skip at
// layer 4, 10 frequencies, 63 -> 16) does about 859k FLOP per point, so
// 0.90 TFLOP per 1,048,576-point call: ~0.91 ms at the H100's 989 TFLOP/s
// dense bf16. It moves only ~46 bytes per point (12 in, 32 out, weights
// 0.86 MB once), so it is compute-bound by three orders of magnitude.
//
// Design, bf16 path: one CTA of 8 warps per 128 points. The encoding is
// computed into shared memory (K padded 63 -> 64, skip 319 -> 320 with zero
// weight rows); activations ping-pong between two shared-memory buffers and
// never reach device memory. Each layer runs as bf16 mma.sync m16n8k16 with
// f32 accumulation, in column blocks of 128 outputs; a warp owns 32 rows x
// 64 columns. Weights are read from global memory (L2/L1-resident) in an
// order pre-packed by the wrapper so that one 16-byte load per lane yields
// the B fragments of two n-tiles.
//
// What this simple design gives up: wgmma (mma.sync reaches well under the
// card's dense peak), TMA and a shared-memory ring for the weights (every
// warp re-reads its B fragments through L1), warp specialisation and
// overlap of one layer's epilogue with the next layer's loads, and more than
// 8 warps per SM (153 KB of shared memory per CTA allows one CTA per SM).
//
// The f32 compute path is a plain FMA loop on the CUDA cores (no TF32, no
// tensor cores), one CTA of 256 threads per 64 points.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: the top frequency reaches
// ~3217 rad per unit of x, where __sinf/__cosf lose all accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kBM = 128;       // points per CTA, bf16 path
constexpr int kBM32 = 64;      // points per CTA, f32 path
constexpr int kThreads = 256;  // 8 warps
constexpr int kNB = 128;       // output columns per pass, bf16 path
constexpr int kPad = 8;        // row padding (elements) of bf16 smem buffers
constexpr int kDescHeader = 9;
constexpr int kDescPerLayer = 5;

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

// x0 tile: the encoded (or raw) input of `rows` points, zero beyond
// enc_dim and beyond the last point.
template <typename T>
__device__ void fill_x0(T* x0, int stride, const float* __restrict__ x,
                        const float* __restrict__ freqs, int row0, int n,
                        int rows, const MlpDesc& d) {
  const int F = d.num_freqs, D = d.in_dim, nf = D * F;
  for (int i = threadIdx.x; i < rows * d.in_pad; i += blockDim.x) {
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
    x0[r * stride + c] = from_f32<T>(v);
  }
}

__device__ __forceinline__ float out_act(float v, int sigmoid) {
  return sigmoid ? 1.f / (1.f + expf(-v)) : v;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_fwd_bf16(const float* __restrict__ x, const uint4* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ freqs,
                   __nv_bfloat16* __restrict__ out, int out_stride, int n, MlpDesc d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x0_stride = d.in_pad + kPad;
  const int h_stride = d.hid_pad + kPad;
  __nv_bfloat16* x0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hbuf0 = x0 + kBM * x0_stride;
  __nv_bfloat16* hbuf1 = hbuf0 + kBM * h_stride;
  const int row0 = blockIdx.x * kBM;
  fill_x0(x0, x0_stride, x, freqs, row0, n, kBM, d);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;  // 4 warps along M, 2 along N
  const int g = lane >> 2, q = lane & 3;
  bool flip = false;

  for (int li = 0; li < d.num_layers; ++li) {
    const LayerDesc L = d.layers[li];
    const bool last = li == d.num_layers - 1;
    const int kt_x0 = (li == 0 || L.skip) ? d.in_pad / 16 : 0;
    const int kt_total = L.k_pad / 16;
    const int np_total = L.n_pad / 16;  // n-tile pairs
    const __nv_bfloat16* hin = flip ? hbuf1 : hbuf0;
    __nv_bfloat16* hout = flip ? hbuf0 : hbuf1;
    const uint4* wl = w + L.w_off / 8;

    for (int nb = 0; nb < L.n_pad; nb += kNB) {
      const int p0 = (nb + wn * 64) / 16;  // first n-tile pair of this warp
      if (p0 >= np_total) continue;       // warp-uniform
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
        if (kt < kt_x0) {
          src = x0; stride = x0_stride; kc = kt * 16;
        } else {
          src = hin; stride = h_stride; kc = (kt - kt_x0) * 16;
        }
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g;
          const uint32_t* p = reinterpret_cast<const uint32_t*>(src + r * stride + kc) + q;
          a[mt][0] = p[0];               // (r,     kc + 2q)
          a[mt][1] = p[4 * stride];      // (r + 8, kc + 2q)
          a[mt][2] = p[4];               // (r,     kc + 8 + 2q)
          a[mt][3] = p[4 * stride + 4];  // (r + 8, kc + 8 + 2q)
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
        if (col >= L.n_pad) continue;
        const float b0 = bias[L.b_off + col], b1 = bias[L.b_off + col + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 32 + mt * 16 + g + 8 * half;
            float v0 = acc[mt][nt][2 * half] + b0;
            float v1 = acc[mt][nt][2 * half + 1] + b1;
            if (!last) {
              __nv_bfloat162 hv = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
              *reinterpret_cast<__nv_bfloat162*>(hout + r * h_stride + col) = hv;
            } else {
              const int row = row0 + r;
              if (row < n) {
                if (col < d.out_dim)
                  out[(size_t)row * out_stride + col] = __float2bfloat16_rn(out_act(v0, d.out_sigmoid));
                if (col + 1 < d.out_dim)
                  out[(size_t)row * out_stride + col + 1] = __float2bfloat16_rn(out_act(v1, d.out_sigmoid));
              }
            }
          }
        }
      }
    }
    __syncthreads();
    flip = !flip;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_f32(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ freqs,
                  float* __restrict__ out, int out_stride, int n, MlpDesc d) {
  extern __shared__ float smem32[];
  const int x0_stride = d.in_pad + 1;
  const int h_stride = d.hid_pad + 1;
  float* x0 = smem32;
  float* hbuf0 = x0 + kBM32 * x0_stride;
  float* hbuf1 = hbuf0 + kBM32 * h_stride;
  const int row0 = blockIdx.x * kBM32;
  fill_x0(x0, x0_stride, x, freqs, row0, n, kBM32, d);
  __syncthreads();

  const int rg = threadIdx.x >> 4;  // rows rg*4 .. rg*4+3
  const int cl = threadIdx.x & 15;  // columns cl + 16 j
  bool flip = false;
  for (int li = 0; li < d.num_layers; ++li) {
    const LayerDesc L = d.layers[li];
    const bool last = li == d.num_layers - 1;
    const int kx0 = (li == 0 || L.skip) ? d.in_pad : 0;
    const float* hin = flip ? hbuf1 : hbuf0;
    float* hout = flip ? hbuf0 : hbuf1;
    const float* wl = w + L.w_off;
    for (int nb = 0; nb < L.n_pad; nb += 64) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < L.k_pad; ++k) {
        const float* src = k < kx0 ? x0 + k : hin + (k - kx0);
        const int stride = k < kx0 ? x0_stride : h_stride;
        float a[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = src[(rg * 4 + i) * stride];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = nb + cl + 16 * j;
          wv[j] = c < L.n_pad ? __ldg(wl + (size_t)k * L.n_pad + c) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb + cl + 16 * j;
        if (c >= L.n_pad) continue;
        const float b = bias[L.b_off + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg * 4 + i;
          const float v = acc[i][j] + b;
          if (!last) {
            hout[r * h_stride + c] = fmaxf(v, 0.f);
          } else if (row0 + r < n && c < d.out_dim) {
            out[(size_t)(row0 + r) * out_stride + c] = out_act(v, d.out_sigmoid);
          }
        }
      }
    }
    __syncthreads();
    flip = !flip;
  }
}

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

// One forward on stream s: x [n, in_dim] f32, out rows of out_stride
// elements (the first out_dim written).
cudaError_t launch_fwd(const float* x, const void* w, const float* bias, const float* freqs,
                       void* out, int out_stride, int n, const MlpDesc& d, int compute_bf16,
                       cudaStream_t s) {
  cudaError_t err;
  if (compute_bf16) {
    const size_t smem = (size_t)kBM * (d.in_pad + kPad) * 2 + 2 * (size_t)kBM * (d.hid_pad + kPad) * 2;
    err = cudaFuncSetAttribute(fused_mlp_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int grid = (n + kBM - 1) / kBM;
    fused_mlp_fwd_bf16<<<grid, kThreads, smem, s>>>(
        x, static_cast<const uint4*>(w), bias, freqs, static_cast<__nv_bfloat16*>(out), out_stride, n, d);
  } else {
    const size_t smem = (size_t)kBM32 * (d.in_pad + 1) * 4 + 2 * (size_t)kBM32 * (d.hid_pad + 1) * 4;
    err = cudaFuncSetAttribute(fused_mlp_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int grid = (n + kBM32 - 1) / kBM32;
    fused_mlp_fwd_f32<<<grid, kThreads, smem, s>>>(
        x, static_cast<const float*>(w), bias, freqs, static_cast<float*>(out), out_stride, n, d);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); desc as parse_desc
// reads it.
extern "C" int fused_mlp_fwd(const void* x, const void* w, const void* bias,
                             const void* freqs, void* out, int n,
                             const int* desc, int desc_len, int compute_bf16,
                             int device, void* stream) {
  MlpDesc d;
  if (!parse_desc(desc, desc_len, d) || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd(static_cast<const float*>(x), w, static_cast<const float*>(bias),
                         static_cast<const float*>(freqs), out, d.out_dim, n, d, compute_bf16,
                         reinterpret_cast<cudaStream_t>(stream));
}
