// Fused ray-march and whole-field backwards for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes). Wrapper, autograd nodes and
// plain PyTorch versions live in nerfstudio_thermal_torch/ops/cuda/fused_ray.py.
//
// Replaces the TPU kernels nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:
// - _ray_bwd_kernel (entry _fused_ray_bwd): recompute x from (o, d, t),
//   walk the MLP back from g (its first out_dim columns, rounded to the
//   compute dtype): dW, db; with need_input_grads also the encoding
//   backward, the contraction's VJP d_pos per point, d_t = d_pos . d, and
//   per ray d_o = sum_s d_pos, d_d = sum_s t d_pos.
// - _field_bwd_kernel (entry _fused_field_bwd): the colour head's walk from
//   g's colour columns (dW, db and d_head_in in f32), g_base = [g_raw,
//   d_geo] rounded to the compute dtype, the base walk (dW, db, d_x), then
//   d_pos and d_t as above, and per ray d_o, d_d = sum_s t d_pos + the SH
//   VJP of sum_s d_sh, and d_emb = sum_s d_emb columns of d_head_in.
//
// What bounds them: the MLP products, three times the forward's (recompute,
// dX, dW; without need_input_grads less layer 0's dX): 6 N x 429,568 MAC
// for the base stack (0.68 ms at N = 262,144 at 989 TFLOP/s bf16), 6 N x
// ~8.4k for the head, 6 N x ~3.1k for a proposal stack without input
// gradients (0.035 ms at 1,048,576). The per-point and per-ray passes move
// ~60-400 bytes a point.
//
// Design: a composition of fused_mlp_bwd.cu's launch_all, run once per
// stack, with per-point and per-ray kernels around it
// (fused_ray_common.cuh, IEEE roundings). launch_all takes the one-pass
// kernel for the 64-wide stacks (the proposals, the colour head: no
// workspace, dW and db in per-CTA slabs) and the three-stage path (walk
// with a device workspace, dW tiles, slab sums) for the 8 x 256 base and
// cross-density stacks; both end in fixed-order sums. The per-ray sums run
// one thread per (ray, component) over the ray's S samples in order: no
// atomics, and a ray whose 128 samples span several point blocks needs no
// cross-block reduction. The head's walk returns d_head_in unrounded
// (MlpDesc.dx_exact), as the TPU kernel keeps d_headin in f32. The head
// input comes from the forward (fused_ray_fwd.cu keeps it), so the base
// stack's forward is recomputed once, by its own walk. Without
// need_input_grads (MlpDesc.no_dx) the walk skips layer 0's dX product and
// the encoding backward, and the per-point and per-ray passes do not run;
// a skip layer's x0 columns of dh_in are still formed (the stacks that run
// without input gradients have no skip).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math.

#include "fused_mlp_bwd.cu"
#include "fused_ray_common.cuh"

namespace {

constexpr int kPointThreads = 256;

inline int point_blocks(long long n) { return (int)((n + kPointThreads - 1) / kPointThreads); }

// Per point: d_pos [n, 3] from d_x [n, 3] through the contraction's VJP,
// and d_t = d_pos . d (components in order).
__global__ void ray_point_bwd(const float* __restrict__ o, const float* __restrict__ d,
                              const float* __restrict__ t, const float* __restrict__ dx,
                              float* __restrict__ d_pos, float* __restrict__ d_t, int n, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = i / S;
  RayPoint p;
  ray_point(o + 3 * r, d + 3 * r, t[i], p);
  float dp[3];
  contract_bwd(p, dx + 3 * i, dp);
  const float* dr = d + 3 * r;
  float acc = __fmul_rn(dp[0], dr[0]);
  acc = __fadd_rn(acc, __fmul_rn(dp[1], dr[1]));
  acc = __fadd_rn(acc, __fmul_rn(dp[2], dr[2]));
  d_t[i] = acc;
#pragma unroll
  for (int k = 0; k < 3; ++k) d_pos[3 * i + k] = dp[k];
}

// One thread per (ray, component), summing the ray's S samples in order.
// Components: 0-2 d_o; 3-5 sum of t d_pos (into d_d); with head_in
// gradients (width > 0), 6-21 d_sh (into dsh [R, 16]) and then the E
// embedding columns of d_head_in (into d_emb [R, E]).
__global__ void ray_sums(const float* __restrict__ d_pos, const float* __restrict__ t,
                         const float* __restrict__ d_head_in, int width, int emb_col, int E,
                         float* __restrict__ d_o, float* __restrict__ d_d,
                         float* __restrict__ dsh, float* __restrict__ d_emb, int n_rays, int S) {
  const int K = 6 + (width > 0 ? 16 + E : 0);
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (long long)n_rays * K) return;
  const int r = (int)(j / K), k = (int)(j - (long long)r * K);
  const long long i0 = (long long)r * S;
  float acc = 0.f;
  if (k < 3) {
    for (int s = 0; s < S; ++s) acc = __fadd_rn(acc, d_pos[3 * (i0 + s) + k]);
    d_o[3 * r + k] = acc;
  } else if (k < 6) {
    for (int s = 0; s < S; ++s) acc = __fadd_rn(acc, __fmul_rn(d_pos[3 * (i0 + s) + k - 3], t[i0 + s]));
    d_d[3 * r + k - 3] = acc;
  } else {
    const int c = k < 22 ? k - 6 : emb_col + (k - 22);
    for (int s = 0; s < S; ++s) acc = __fadd_rn(acc, d_head_in[(i0 + s) * width + c]);
    if (k < 22) {
      dsh[16 * r + k - 6] = acc;
    } else {
      d_emb[(long long)E * r + k - 22] = acc;
    }
  }
}

// Per ray: d_d += the SH VJP of the ray's summed d_sh.
__global__ void ray_sh_bwd(const float* __restrict__ d, const float* __restrict__ dsh,
                           float* __restrict__ d_d, int n_rays) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float v[3];
  sh4_vjp(d + 3 * r, dsh + 16 * r, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) d_d[3 * r + k] = __fadd_rn(d_d[3 * r + k], v[k]);
}

// g_base [n, 1 + geo] = [g[:, C] | d_head_in[:, 16 : 16 + geo]] rounded to T.
template <typename T>
__global__ void field_g_base(const T* __restrict__ g, const float* __restrict__ d_head_in,
                             T* __restrict__ g_base, int n, int C, int geo, int width) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (long long)n * (1 + geo)) return;
  const long long i = j / (1 + geo);
  const int c = (int)(j - i * (1 + geo));
  g_base[j] = c == 0 ? g[i * (C + 2) + C] : ray_cast<T>(d_head_in[i * width + 16 + c - 1]);
}

template <typename T>
cudaError_t ray_bwd(const float* o, const float* d, const float* t, const T* g, const void* w,
                    const void* wt, const float* bias, const float* freqs, T* ws, float* scratch,
                    float* x, float* dx, float* d_pos, float* dw, float* db, float* d_o, float* d_d,
                    float* d_t, int n_rays, int S, MlpDesc md, int need_input_grads,
                    int sms, cudaStream_t s) {
  const int n = n_rays * S;
  ray_prologue<<<point_blocks(n), kPointThreads, 0, s>>>(o, d, t, x, n, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  md.no_dx = !need_input_grads;
  const Plan plan = make_plan(md, n, sizeof(T) == 2, sms);
  err = launch_all<T>(x, g, w, wt, bias, freqs, ws, scratch, dx, dw, db, n, md, plan, s);
  if (err != cudaSuccess || !need_input_grads) return err;
  ray_point_bwd<<<point_blocks(n), kPointThreads, 0, s>>>(o, d, t, dx, d_pos, d_t, n, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ray_sums<<<point_blocks((long long)n_rays * 6), kPointThreads, 0, s>>>(
      d_pos, t, nullptr, 0, 0, 0, d_o, d_d, nullptr, nullptr, n_rays, S);
  return cudaGetLastError();
}

struct FieldPtrs {
  const float *o, *d, *t, *head_in, *freqs;
  const void *bw, *bwt, *hw, *hwt;
  const float *bb, *hb;
  float *scratch, *x, *d_head_in, *dx, *d_pos, *dsh;
  float *dbw, *dbb, *dhw, *dhb, *d_o, *d_d, *d_t, *d_emb;
};

template <typename T>
cudaError_t field_bwd(const FieldPtrs& p, const T* g, const T* g_rgb, T* g_base, T* ws, int n_rays,
                      int S, int E, MlpDesc base, MlpDesc head, int sms, cudaStream_t s) {
  const int n = n_rays * S;
  const int C = head.out_dim, geo = base.out_dim - 1, width = head.in_dim;
  ray_prologue<<<point_blocks(n), kPointThreads, 0, s>>>(p.o, p.d, p.t, p.x, n, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head.dx_exact = 1;
  const int bf16 = sizeof(T) == 2;
  err = launch_all<T>(p.head_in, g_rgb, p.hw, p.hwt, p.hb, p.freqs, ws, p.scratch, p.d_head_in,
                      p.dhw, p.dhb, n, head, make_plan(head, n, bf16, sms), s);
  if (err != cudaSuccess) return err;
  field_g_base<T><<<point_blocks((long long)n * (1 + geo)), kPointThreads, 0, s>>>(
      g, p.d_head_in, g_base, n, C, geo, width);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_all<T>(p.x, g_base, p.bw, p.bwt, p.bb, p.freqs, ws, p.scratch, p.dx, p.dbw, p.dbb,
                      n, base, make_plan(base, n, bf16, sms), s);
  if (err != cudaSuccess) return err;
  ray_point_bwd<<<point_blocks(n), kPointThreads, 0, s>>>(p.o, p.d, p.t, p.dx, p.d_pos, p.d_t, n, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ray_sums<<<point_blocks((long long)n_rays * (22 + E)), kPointThreads, 0, s>>>(
      p.d_pos, p.t, p.d_head_in, width, 16 + geo, E, p.d_o, p.d_d, p.dsh, p.d_emb, n_rays, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ray_sh_bwd<<<point_blocks(n_rays), kPointThreads, 0, s>>>(p.d, p.dsh, p.d_d, n_rays);
  return cudaGetLastError();
}

}  // namespace

// One fused ray-march backward on `stream`. Inputs: origins, dirs
// [n_rays, 3], ts [n] f32 (n = n_rays S), g [n, out_dim] in the compute
// dtype, the MLP packed as for fused_mlp_bwd (w, wt, bias, freqs, desc).
// Workspace and scratch sized by fused_mlp_bwd_sizes for n points; x, dx,
// d_pos [n, 3] f32 scratch. Outputs dw, db (padded layout, as
// fused_mlp_bwd), and with need_input_grads d_o, d_d [n_rays, 3] and d_t
// [n] f32. Returns the cudaError_t of the launches.
extern "C" int fused_ray_bwd(const void* o, const void* d, const void* t, const void* g,
                             const void* w, const void* wt, const void* bias, const void* freqs,
                             void* ws, void* scratch, void* x, void* dx, void* d_pos, void* dw,
                             void* db, void* d_o, void* d_d, void* d_t, int n_rays, int S,
                             const int* desc, int desc_len, int compute_bf16,
                             int need_input_grads, int device, void* stream) {
  MlpDesc md;
  if (!parse_desc(desc, desc_len, md) || md.in_dim != 3 || md.num_freqs <= 0 ||
      n_rays <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(d);
  const float* tf = static_cast<const float*>(t);
  const float* bf = static_cast<const float*>(bias);
  const float* ff = static_cast<const float*>(freqs);
  float* f[9] = {static_cast<float*>(scratch), static_cast<float*>(x), static_cast<float*>(dx),
                 static_cast<float*>(d_pos), static_cast<float*>(dw), static_cast<float*>(db),
                 static_cast<float*>(d_o), static_cast<float*>(d_d), static_cast<float*>(d_t)};
  const int sms = num_sms(device);
  if (compute_bf16) {
    err = ray_bwd(of, df, tf, static_cast<const __nv_bfloat16*>(g), w, wt, bf, ff,
                  static_cast<__nv_bfloat16*>(ws), f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                  f[8], n_rays, S, md, need_input_grads, sms, s);
  } else {
    err = ray_bwd(of, df, tf, static_cast<const float*>(g), w, wt, bf, ff,
                  static_cast<float*>(ws), f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                  n_rays, S, md, need_input_grads, sms, s);
  }
  return (int)err;
}

// One whole-field backward on `stream`. Inputs: origins, dirs [n_rays, 3],
// ts [n] f32; g [n, C + 2] and g_rgb [n, C] (g's colour columns) in the
// compute dtype; head_in [n, 16 + geo + E] f32 from the forward; the base
// stack (bw, bwt, bb, freqs, base_desc) and the head stack (hw, hwt, hb,
// head_desc) packed as for fused_mlp_bwd. Workspace and scratch sized by
// fused_mlp_bwd_sizes for the larger of the two stacks at n points (the
// head's one-pass kernel needs no workspace).
// Scratch: x, dx, d_pos [n, 3] f32, d_head_in [n, 16 + geo + E] f32, g_base
// [n, 1 + geo] in the compute dtype, dsh [n_rays, 16] f32. Outputs dbw, dbb,
// dhw, dhb (padded layouts), d_o, d_d [n_rays, 3], d_t [n], d_emb
// [n_rays, E] f32. Returns the cudaError_t of the launches.
extern "C" int fused_field_bwd(const void* o, const void* d, const void* t, const void* g,
                               const void* g_rgb, const void* head_in, const void* bw,
                               const void* bwt, const void* bb, const void* freqs, const void* hw,
                               const void* hwt, const void* hb, void* ws, void* scratch, void* x,
                               void* dx, void* d_pos, void* d_head_in, void* g_base, void* dsh,
                               void* dbw, void* dbb, void* dhw, void* dhb, void* d_o, void* d_d,
                               void* d_t, void* d_emb, int n_rays, int S, int E,
                               const int* base_desc, int base_len, const int* head_desc,
                               int head_len, int compute_bf16, int device, void* stream) {
  MlpDesc base, head;
  if (!parse_desc(base_desc, base_len, base) || !parse_desc(head_desc, head_len, head) ||
      base.in_dim != 3 || base.num_freqs <= 0 || head.num_freqs != 0 || !head.out_sigmoid ||
      head.in_dim != 16 + (base.out_dim - 1) + E || n_rays <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  FieldPtrs p;
  p.o = static_cast<const float*>(o);
  p.d = static_cast<const float*>(d);
  p.t = static_cast<const float*>(t);
  p.head_in = static_cast<const float*>(head_in);
  p.freqs = static_cast<const float*>(freqs);
  p.bw = bw;
  p.bwt = bwt;
  p.hw = hw;
  p.hwt = hwt;
  p.bb = static_cast<const float*>(bb);
  p.hb = static_cast<const float*>(hb);
  p.scratch = static_cast<float*>(scratch);
  p.x = static_cast<float*>(x);
  p.d_head_in = static_cast<float*>(d_head_in);
  p.dx = static_cast<float*>(dx);
  p.d_pos = static_cast<float*>(d_pos);
  p.dsh = static_cast<float*>(dsh);
  p.dbw = static_cast<float*>(dbw);
  p.dbb = static_cast<float*>(dbb);
  p.dhw = static_cast<float*>(dhw);
  p.dhb = static_cast<float*>(dhb);
  p.d_o = static_cast<float*>(d_o);
  p.d_d = static_cast<float*>(d_d);
  p.d_t = static_cast<float*>(d_t);
  p.d_emb = static_cast<float*>(d_emb);
  const int sms = num_sms(device);
  if (compute_bf16) {
    using B = __nv_bfloat16;
    err = field_bwd(p, static_cast<const B*>(g), static_cast<const B*>(g_rgb), static_cast<B*>(g_base),
                    static_cast<B*>(ws), n_rays, S, E, base, head, sms, s);
  } else {
    err = field_bwd(p, static_cast<const float*>(g), static_cast<const float*>(g_rgb),
                    static_cast<float*>(g_base), static_cast<float*>(ws), n_rays, S, E, base, head,
                    sms, s);
  }
  return (int)err;
}
