// Fused ray-march and whole-field forwards for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes). Wrapper, autograd nodes and
// plain PyTorch versions live in nerfstudio_thermal_torch/ops/cuda/fused_ray.py.
//
// Replaces the TPU kernels nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:
// - _ray_fwd_kernel (entry fused_ray_mlp): from per-ray origins and
//   directions [R, 3] and per-sample midpoints [R S, 1], pos = o + t d, the
//   inf-norm scene contraction, (x + 2) / 4 and the in-box selector, x =
//   p01 sel, then the frequency encoding and the MLP of fused_mlp_fwd.cu.
//   Output [R S, out + 1] in the compute dtype, the selector last.
// - _field_fwd_kernel (entry fused_field_mlp): the same base stack, then the
//   colour head on [SH4(dir) rounded to the compute dtype | the base
//   output's geo columns | the ray's appearance embedding rounded to the
//   compute dtype]: relu, relu, sigmoid. Output [R S, C + 2]: colour, the
//   raw density (base output column 0) and the selector.
//
// What bounds them: the MLP products. The ray forward of the cross density
// (8 x 256, skip at 4, 10 frequencies) does ~859k FLOP per point, 0.91 ms
// of bf16 tensor-core time per 1,048,576-point chunk; the colour head adds
// ~17k FLOP per point; the 64-wide proposal stacks (3 x 64, 5 or 7
// frequencies) do ~14-16k FLOP per point against ~30-42 sin/cos, and even
// there the f32 encoding and contraction work bounds about ten times below
// the products (chip_smoke.py's bound terms). The ray prologue moves 12
// bytes of x per point; rays cost 24 bytes each and midpoints 4 per point.
//
// Design: a composition of fused_mlp_fwd.cu's kernels. A prologue kernel
// (one thread per point, IEEE roundings, fused_ray_common.cuh) writes x
// [n, 3] f32 and the selector column of the output; the fused-MLP forward
// runs the stack on x, on the path launch_fwd picks (the one-pass narrow
// kernel for the 64-wide proposal stacks and the colour head, the wgmma
// kernel for the 8 x 256 stacks), writing its rows with the output's
// stride.
// The whole-field forward runs the base stack into a [n, 16] buffer, a
// second kernel (one thread per element, so that the stores coalesce)
// assembles the head input [n, 16 + geo + E] in f32 (every value rounded
// to the compute dtype, so exactly what the head's x0 tile holds) and
// copies the raw density, and the fused-MLP kernel runs the head into the
// output. What this gives up against one kernel per
// point block: x (12 B), the base output (32 B) and the head input (252 B
// for E = 32) make a round trip through device memory. The head input is
// kept: the whole-field backward reads it instead of recomputing the base
// stack a second time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math (see fused_mlp_fwd.cu).

#include "fused_mlp_fwd.cu"
#include "fused_ray_common.cuh"

namespace {

constexpr int kPointThreads = 256;

// One thread per element of head_in [n, 16 + geo + E]: for point i of ray
// r = i / S, [SH4(d_r) | base_out[i, 1:] | emb_r], each value rounded to
// the compute dtype T (neighbouring threads write neighbouring columns);
// the thread of column 0 also copies out[i, C] = base_out[i, 0].
template <typename T>
__global__ void field_head_input(const float* __restrict__ d, const float* __restrict__ emb,
                                 const T* __restrict__ base_out, float* __restrict__ head_in,
                                 T* __restrict__ out, int n, int S, int geo, int E, int C) {
  const int width = 16 + geo + E;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (long long)n * width) return;
  const long long i = j / width;
  const int c = (int)(j - i * width);
  const long long r = i / S;
  const T* b = base_out + i * (1 + geo);
  float v;
  if (c < 16) {
    float sh[16];
    sh4(d + 3 * r, sh);
    v = ray_f32(ray_cast<T>(sh[c]));
  } else if (c < 16 + geo) {
    v = ray_f32(b[1 + c - 16]);
  } else {
    v = ray_f32(ray_cast<T>(emb[r * E + c - 16 - geo]));
  }
  head_in[j] = v;
  if (c == 0) out[i * (C + 2) + C] = b[0];
}

inline int blocks(long long n) { return (int)((n + kPointThreads - 1) / kPointThreads); }

// One stack's packed weights, in the mma order and the wgmma order (see
// fused_mlp_fwd.cu launch_fwd, which picks the path that reads them).
struct Stack {
  const void* w;
  const void* w_wg;
  long long wg_elems;
  const float* bias;
};

template <typename T>
cudaError_t ray_fwd(const float* o, const float* d, const float* t, const Stack& st,
                    const float* freqs, float* x, T* out, int n, int S, const MlpDesc& md,
                    int bf16, cudaStream_t s) {
  const int stride = md.out_dim + 1;
  ray_prologue<T><<<blocks(n), kPointThreads, 0, s>>>(o, d, t, x, out, stride, md.out_dim, n, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fwd(x, st.w, st.w_wg, st.wg_elems, st.bias, freqs, out, stride, n, md, bf16, s);
}

template <typename T>
cudaError_t field_fwd(const float* o, const float* d, const float* t, const float* emb,
                      const Stack& bst, const float* freqs, const Stack& hst, float* x, T* base_out,
                      float* head_in, T* out, int n, int S, int E, const MlpDesc& base,
                      const MlpDesc& head, int bf16, cudaStream_t s) {
  const int C = head.out_dim, geo = base.out_dim - 1;
  ray_prologue<T><<<blocks(n), kPointThreads, 0, s>>>(o, d, t, x, out, C + 2, C + 1, n, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_fwd(x, bst.w, bst.w_wg, bst.wg_elems, bst.bias, freqs, base_out, base.out_dim, n, base,
                   bf16, s);
  if (err != cudaSuccess) return err;
  field_head_input<T><<<blocks((long long)n * (16 + geo + E)), kPointThreads, 0, s>>>(
      d, emb, base_out, head_in, out, n, S, geo, E, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_fwd(head_in, hst.w, hst.w_wg, hst.wg_elems, hst.bias, freqs, out, C + 2, n, head, bf16,
                    s);
}

}  // namespace

// One fused ray-march forward on `stream`: origins, dirs [n_rays, 3] f32,
// ts [n_rays * S] f32, the MLP packed as for fused_mlp_fwd (desc, weights,
// wgmma-order weights, biases, frequencies; in_dim 3 with the encoding),
// bf16 the compute dtype (0: f32). Scratch x [n, 3] f32; out [n, out_dim +
// 1] in the compute dtype. Returns the cudaError_t.
extern "C" int fused_ray_fwd(const void* o, const void* d, const void* t, const void* w,
                             const void* w_wg, long long wg_elems, const void* bias,
                             const void* freqs, void* x, void* out, int n_rays, int S,
                             const int* desc, int desc_len, int bf16, int device, void* stream) {
  MlpDesc md;
  if (!parse_desc(desc, desc_len, md) || md.in_dim != 3 || md.num_freqs <= 0 || n_rays <= 0 ||
      S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = n_rays * S;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(d);
  const float* tf = static_cast<const float*>(t);
  const Stack st{w, w_wg, wg_elems, static_cast<const float*>(bias)};
  const float* ff = static_cast<const float*>(freqs);
  float* xf = static_cast<float*>(x);
  if (bf16) {
    err = ray_fwd(of, df, tf, st, ff, xf, static_cast<__nv_bfloat16*>(out), n, S, md, bf16, s);
  } else {
    err = ray_fwd(of, df, tf, st, ff, xf, static_cast<float*>(out), n, S, md, bf16, s);
  }
  return (int)err;
}

// One whole-field forward on `stream`: origins, dirs [n_rays, 3], ts
// [n_rays * S], emb [n_rays, E] f32; the base stack packed with the
// encoding (in_dim 3, out 1 + geo) and the head stack without (in_dim
// 16 + geo + E, sigmoid, out C), each with its wgmma-order weights; bf16
// the compute dtype of both (0: f32). Scratch x [n, 3] f32 and base_out
// [n, 1 + geo] in the compute dtype; head_in [n, 16 + geo + E] f32 (kept
// for the backward); out [n, C + 2] in the compute dtype.
extern "C" int fused_field_fwd(const void* o, const void* d, const void* t, const void* emb,
                               const void* bw, const void* bw_wg, long long b_wg_elems,
                               const void* bb, const void* freqs, const void* hw, const void* hw_wg,
                               long long h_wg_elems, const void* hb, void* x, void* base_out,
                               void* head_in, void* out, int n_rays, int S, int E,
                               const int* base_desc, int base_len, const int* head_desc,
                               int head_len, int bf16, int device, void* stream) {
  MlpDesc base, head;
  if (!parse_desc(base_desc, base_len, base) || !parse_desc(head_desc, head_len, head) ||
      base.in_dim != 3 || base.num_freqs <= 0 || head.num_freqs != 0 || !head.out_sigmoid ||
      head.in_dim != 16 + (base.out_dim - 1) + E || n_rays <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = n_rays * S;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(d);
  const float* tf = static_cast<const float*>(t);
  const float* ef = static_cast<const float*>(emb);
  const Stack bst{bw, bw_wg, b_wg_elems, static_cast<const float*>(bb)};
  const Stack hst{hw, hw_wg, h_wg_elems, static_cast<const float*>(hb)};
  const float* ff = static_cast<const float*>(freqs);
  float* xf = static_cast<float*>(x);
  float* hif = static_cast<float*>(head_in);
  if (bf16) {
    err = field_fwd(of, df, tf, ef, bst, ff, hst, xf, static_cast<__nv_bfloat16*>(base_out), hif,
                    static_cast<__nv_bfloat16*>(out), n, S, E, base, head, bf16, s);
  } else {
    err = field_fwd(of, df, tf, ef, bst, ff, hst, xf, static_cast<float*>(base_out), hif,
                    static_cast<float*>(out), n, S, E, base, head, bf16, s);
  }
  return (int)err;
}
