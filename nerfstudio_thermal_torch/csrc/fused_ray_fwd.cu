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
// the products (chip_smoke.py's bound terms). Rays cost 24 bytes each and
// midpoints 4 per point; the contracted positions never leave the kernel.
//
// Design: fused_mlp_fwd.cu's kernels, instantiated here with two x0 fills
// of their own. RayFill contracts each sample of the group's rows into
// shared memory (one thread a row: ray_point with IEEE roundings,
// fused_ray_common.cuh) and writes its selector column of the output; the
// kernel then encodes the contracted positions as it encodes x. Every path
// takes it: the wgmma kernel (the 8 x 256 stacks: row 3's cross density,
// row 5's base), the narrow kernel (the 64-wide proposal stacks) and the
// f32 kernel, so a ray-march forward is one launch. Rows are written with
// the output's stride.
// The whole-field forward is two launches: the base stack (RayFill) into a
// [n, 1 + geo] buffer, then the head (the narrow kernel; f32, or wgmma for
// a head wider than 64), whose HeadFill assembles its x0 tile: SH4 of each
// ray its rows reach, computed once per ray and group, the base output's
// geo columns and the ray's embedding, each rounded to the compute dtype,
// as the plain version rounds them. It copies the raw density into the
// output and, only when a backward can follow, writes the head input [n,
// 16 + geo + E] f32, which the whole-field backward reads instead of
// recomputing the base stack. What this still gives up against one kernel
// per point block: the base output (32 B a point) makes a round trip
// through device memory, and the head has a launch of its own.
// Measured at 1,048,576 points, C = 3, bf16 (H100 80GB HBM3, 700 W;
// chip_smoke.py's field_split line, device ms per kernel): the first
// design's four launches took 3.90 ms (prologue 0.012, base 3.03, a kernel
// assembling the head input one thread per element 0.66, head 0.26); now
// 3.24-3.30 without the head input (base, contracting itself, 3.02-3.04;
// head with its assembly 0.29) and 3.32-3.39 writing it (head 0.35). The
// contraction in the kernel, against the prologue kernel and x [n, 3]
// (chip_smoke.py's ray_kernel_phase): the cross density 3.07 -> 2.99-3.03
// ms at 1,048,576 points, the proposals 1.07-1.08 -> 0.92-0.93 at
// 4,194,304 and 0.39 -> 0.35 at 1,572,864; a first RayFill that contracted
// one thread a row and then waited at a barrier read the cross density 1%
// slower than the prologue design. The head assembly, tried in
// turn: one value per thread and step with a division by S each, 0.56-0.68
// ms for the head kernel; a batch of loads before their stores, the same;
// each row's ray looked up from a table built once per tile, 0.44; the base
// columns and the embedding as two loops whose warps each take one branch,
// 0.29. (Ablations of the first: no division 0.41, no loads 0.28, zeros
// alone 0.20.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math (see fused_mlp_fwd.cu).

#include "fused_mlp_fwd.cu"
#include "fused_ray_common.cuh"

namespace {

// A point fill (fused_mlp_fwd.cu, "x0 fills"): x of row i is the
// contracted sample o_r + t_i d_r of ray r = i / S, computed into the
// scratch by prepare (every thread its row; a row's threads write the same
// values), whose first thread of a row also writes the row's selector to
// sel[i * sel_stride + sel_col] in the compute dtype.
struct RayFill {
  static constexpr bool kTile = false;
  static constexpr int kScratch = 3;
  const float* o;  // [R, 3] origins
  const float* d;  // [R, 3] directions
  const float* t;  // [R S] midpoints
  int S;           // samples per ray
  void* sel;
  int sel_stride, sel_col;

  template <typename T>
  __device__ void prepare(int n, int row0, int rows, int tid, int, float* sc) const {
    const int r = tid % rows, row = row0 + r;
    if (row >= n) return;
    const int ray = row / S;
    RayPoint p;
    ray_point(o + 3 * (size_t)ray, d + 3 * (size_t)ray, t[row], p);
#pragma unroll
    for (int k = 0; k < 3; ++k) sc[3 * r + k] = p.x[k];
    if (tid < rows) static_cast<T*>(sel)[(size_t)row * sel_stride + sel_col] = ray_cast<T>(p.sel);
  }
  __device__ float value(const float* sc, int, int r, int k) const { return sc[3 * r + k]; }
};

// A tile fill: the whole field's colour-head input. Row i of ray r = i / S
// is [SH4(d_r) | base[i, 1:] | emb_r], each value rounded to the compute
// dtype T (the plain version's _head_input), zero beyond that width up to
// `cols` and from row n on. Also copies each row's raw density base[i, 0]
// to out[i, C] and, when head_in is given, writes the values there in f32.
// The scratch holds SH4 of each ray the group's rows reach, computed once
// per ray, and each row's ray (less the first), so that no thread divides
// by S per value. The base rows and then the embeddings are read
// kHeadBatch loads a thread at a time, issued before their stores, each
// segment on its own so that a warp's lanes take one branch; neighbouring
// threads take neighbouring columns, so the loads and stores coalesce.
constexpr int kHeadBatch = 8;

struct HeadFill {
  static constexpr bool kTile = true;
  static constexpr int kScratch = 17;  // 16 SH values (of at most one ray a row) and the row's ray
  const float* d;    // [R, 3] directions
  const float* emb;  // [R, E] appearance embeddings
  const void* base;  // [n, 1 + geo] the base stack's output, in the compute dtype
  void* out;         // [n, C + 2] the field's output: the raw density goes to column C
  float* head_in;    // [n, 16 + geo + E] f32 (the backward's input), or null
  int S, geo, E, C;

  template <typename T, typename Put, typename Sync>
  __device__ void tile(int n, int row0, int rows, int cols, int tid, int nthr, float* sh, Put put,
                       Sync sync) const {
    const int valid = max(0, min(rows, n - row0));
    const int ray0 = row0 / S;
    const int rays = valid > 0 ? (row0 + valid - 1) / S - ray0 + 1 : 0;
    int* ray_of = reinterpret_cast<int*>(sh + 16 * rows);  // a row's ray less ray0
    for (int j = tid; j < rays; j += nthr) {
      float v[16];
      sh4(d + 3 * (size_t)(ray0 + j), v);
#pragma unroll
      for (int k = 0; k < 16; ++k) sh[16 * j + k] = ray_f32(ray_cast<T>(v[k]));
    }
    for (int r = tid; r < valid; r += nthr) ray_of[r] = (row0 + r) / S - ray0;
    sync();
    const int width = 16 + geo + E, bw = 1 + geo;
    const T* b = static_cast<const T*>(base);
    // the base rows, then the embeddings: per segment of `per_row` columns a
    // row, kHeadBatch elements a thread at a time, all their loads before
    // their stores; (r, k) steps by nthr elements
    auto segment = [&](int per_row, auto load, auto store) {
      const int step_r = nthr / per_row, step_k = nthr - step_r * per_row;
      auto next = [&](int& r, int& k) {
        r += step_r;
        k += step_k;
        if (k >= per_row) {
          k -= per_row;
          ++r;
        }
      };
      int r0 = tid / per_row, k0 = tid - r0 * per_row;
      for (int e0 = 0; e0 < rows * per_row; e0 += kHeadBatch * nthr) {
        float v[kHeadBatch];
        int r = r0, k = k0;
#pragma unroll
        for (int j = 0; j < kHeadBatch; ++j, next(r, k)) v[j] = r < valid ? load(r, k) : 0.f;
        r = r0;
        k = k0;
#pragma unroll
        for (int j = 0; j < kHeadBatch; ++j, next(r, k)) {
          if (r >= rows) break;
          store(r, k, v[j]);
        }
        r0 = r;
        k0 = k;
      }
    };
    auto store_column = [&](int r, int c, float v) {
      put(r, c, v);
      if (head_in != nullptr && r < valid) head_in[((size_t)row0 + r) * width + c] = v;
    };
    segment(
        bw, [&](int r, int k) { return ray_f32(b[((size_t)row0 + r) * bw + k]); },
        [&](int r, int k, float v) {
          if (k > 0) {
            store_column(r, 15 + k, v);
          } else if (r < valid) {
            static_cast<T*>(out)[((size_t)row0 + r) * (C + 2) + C] = ray_cast<T>(v);
          }
        });
    segment(
        E, [&](int r, int k) { return ray_f32(ray_cast<T>(emb[(size_t)(ray0 + ray_of[r]) * E + k])); },
        [&](int r, int k, float v) { store_column(r, 16 + geo + k, v); });
    // the SH columns, then zeros up to cols
    for (int e = tid; e < rows * 16; e += nthr) {
      const int r = e >> 4, c = e & 15;
      store_column(r, c, r < valid ? sh[16 * ray_of[r] + c] : 0.f);
    }
    for (int c = width; c < cols; ++c)
      for (int r = tid; r < rows; r += nthr) put(r, c, 0.f);
  }
};

// One stack's packed weights, in the mma order and the wgmma order (see
// fused_mlp_fwd.cu launch_fwd, which picks the path that reads them).
struct Stack {
  const void* w;
  const void* w_wg;
  long long wg_elems;
  const float* bias;
};

// Two launches: the base stack (its input contracted in the kernel) into
// base_out, then the head, whose kernel assembles its input from SH4(d),
// base_out and emb, copies the raw density and, when head_in is given,
// writes the input there for the backward.
cudaError_t field_fwd(const float* o, const float* d, const float* t, const float* emb, const Stack& bst,
                      const float* freqs, const Stack& hst, void* base_out, float* head_in, void* out, int n, int S,
                      int E, const MlpDesc& base, const MlpDesc& head, int bf16, cudaStream_t s) {
  const int C = head.out_dim, geo = base.out_dim - 1;
  const cudaError_t err = launch_fwd(RayFill{o, d, t, S, out, C + 2, C + 1}, bst.w, bst.w_wg, bst.wg_elems, bst.bias,
                                     freqs, base_out, base.out_dim, n, base, bf16, s);
  if (err != cudaSuccess) return err;
  return launch_fwd(HeadFill{d, emb, base_out, out, head_in, S, geo, E, C}, hst.w, hst.w_wg, hst.wg_elems, hst.bias,
                    freqs, out, C + 2, n, head, bf16, s);
}

}  // namespace

// One fused ray-march forward on `stream`: origins, dirs [n_rays, 3] f32,
// ts [n_rays * S] f32, the MLP packed as for fused_mlp_fwd (desc, weights,
// wgmma-order weights, biases, frequencies; in_dim 3 with the encoding),
// bf16 the compute dtype (0: f32); out [n, out_dim + 1] in the compute
// dtype, the selector last. One launch. Returns the cudaError_t.
extern "C" int fused_ray_fwd(const void* o, const void* d, const void* t, const void* w,
                             const void* w_wg, long long wg_elems, const void* bias,
                             const void* freqs, void* out, int n_rays, int S,
                             const int* desc, int desc_len, int bf16, int device, void* stream) {
  MlpDesc md;
  if (!parse_desc(desc, desc_len, md) || md.in_dim != 3 || md.num_freqs <= 0 || n_rays <= 0 ||
      S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RayFill fill{static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t), S,
                     out, md.out_dim + 1, md.out_dim};
  return (int)launch_fwd(fill, w, w_wg, wg_elems, static_cast<const float*>(bias), static_cast<const float*>(freqs),
                         out, md.out_dim + 1, n_rays * S, md, bf16, reinterpret_cast<cudaStream_t>(stream));
}

// One whole-field forward on `stream`: origins, dirs [n_rays, 3], ts
// [n_rays * S], emb [n_rays, E] f32; the base stack packed with the
// encoding (in_dim 3, out 1 + geo) and the head stack without (in_dim
// 16 + geo + E, sigmoid, out C), each with its wgmma-order weights; bf16
// the compute dtype of both (0: f32). Scratch base_out [n, 1 + geo] in the
// compute dtype; head_in [n, 16 + geo + E] f32, written for the backward,
// or null (nothing written); out [n, C + 2] in the compute dtype.
extern "C" int fused_field_fwd(const void* o, const void* d, const void* t, const void* emb,
                               const void* bw, const void* bw_wg, long long b_wg_elems,
                               const void* bb, const void* freqs, const void* hw, const void* hw_wg,
                               long long h_wg_elems, const void* hb, void* base_out,
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
  const Stack bst{bw, bw_wg, b_wg_elems, static_cast<const float*>(bb)};
  const Stack hst{hw, hw_wg, h_wg_elems, static_cast<const float*>(hb)};
  return (int)field_fwd(static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t),
                        static_cast<const float*>(emb), bst, static_cast<const float*>(freqs), hst, base_out,
                        static_cast<float*>(head_in), out, n_rays * S, S, E, base, head, bf16,
                        reinterpret_cast<cudaStream_t>(stream));
}
