// K3, K4 and K5 in their bfloat16 mode. Replaces the bfloat16 instantiation
// of temp_tpu/ops/fused_final.py:_fwd_kernel, _bwd_loss_kernel and
// _bwd_layer_kernel.
//
// K3's score and reduce launches and K4: fused_final.cu compiled with
// TK_BF16 1 (fused_final.cu and rgcn_gru_layer.cuh say what the mode
// computes), their launchers exported with the suffix _bf16.
//
// K3's layer launches (also K11's in bfloat16) and K5: their own kernels
// on the native bfloat16 routines of window_bf16.cuh (mma.sync m16n8k16
// bf16, fragments by ldmatrix, operands staged once as bfloat16 by
// cp.async; its note says what they compute), with the launches and
// arguments of fused_final.cu's (its note describes them), exported as
// final_layer_launch_bf16, final_bwd_gru_launch_bf16,
// final_bwd_input_launch_bf16 and final_wgrad_launch_bf16. They are K2f's
// and K2b's bfloat16 launches (fused_window_bf16.cu) at one step (L1 = 1,
// k = 0) over all N rows against the dense history. The operands: the
// layer's input x (layer 1's embeddings, layer 2's K3 output) bfloat16,
// rounded once by the wrapper; loopw, wih_t, whh_t, wih, whh and loop_t the
// wrapper's bfloat16 copies of the weights; the history bfloat16; conv_s
// and h0g_s bfloat16 scratch (the weight launch reads them only rounded);
// the masks, biases, relation weights, the layer's float32 output and every
// cotangent float32.
//
// The layer launch (final_layer_kernel) is K2f's tile, fwd_layer_tile_bf,
// with the select of layer 2 in its output, in whole-width tiles as
// float32's (fused_final.cu): 32 rows of kFinalBfWarps = 8 warps, one slab
// of all d = 128 columns of every gate, so each block forms the conv
// output of its rows (the SpMM and the self-loop product) once; 1,784
// blocks at the main shape (B = 8, N = 7,128, d = 128), 110,080 bytes, two
// an SM. K2f's own shape (four warps, two slabs of 64 columns, the conv
// formed in both; 3,568 blocks of 73,216 bytes, three an SM) took 0.528
// ms of device time a step for both layers where this one took 0.374 on
// an H100. Its products are K2f's and K5's routines (conv_tc_bf,
// gate_products_bf), whose sums do not depend on the tile's rows or slab,
// so the conv output and the gates of K3's layer 2 equal bit for bit
// those K2f forms on the same rows and those K5's GRU launch recomputes.
//
// K5: d_out comes from dout [B, N, d]; the previous state's cotangent goes
// to dprev at the row itself (bwd_gru_tile_bf's dprev); there is no g_loc.
// At the main shape the GRU tile is 16 rows of 8 warps, 3,568 blocks of
// K2b's 68,096 bytes, three an SM; the input tile 32 rows, 1,784 blocks;
// the weight launch K2b's tiles with three jobs, 28 tiles by 16 ranges (448
// blocks of 128 threads). No atomics; the weight sums go to per-range
// copies reduced in a fixed order by the float32 build's reduction, so
// runs repeat bit for bit.
#define TK_BF16 1
#define final_scores_launch final_scores_launch_bf16
#define final_loss_reduce_launch final_loss_reduce_launch_bf16
#define final_dq_launch final_dq_launch_bf16
#define final_dq_finish_launch final_dq_finish_launch_bf16
#define final_dtable_launch final_dtable_launch_bf16
#include "fused_final.cu"
#include "window_bf16.cuh"

namespace {

// K3's layer block in bfloat16: kFinalBfWarps warps of 16 columns, so one
// slab of all d = 128 columns of every gate, two blocks an SM.
constexpr int kFinalBfWarps = 8;
constexpr int kFinalBfBlocks = 2;

// One encoder layer of the final step for the 32-row tile blockIdx.x /
// slabs of element blockIdx.y at slab blockIdx.x % slabs of every gate
// (fwd_layer_tile_bf: one step of all N rows against the dense history);
// layer 2 also applies the select (active[row] <= 0 keeps the input row
// sel_x, float32).
__global__ void __launch_bounds__(kFinalBfWarps * kWarp, kFinalBfBlocks)
    final_layer_kernel(Layer p, const float* __restrict__ sel_x,
                       const float* __restrict__ active,
                       float* __restrict__ out, int slabs) {
  const int d = p.d;
  const int a0 = (blockIdx.x / slabs) * kBwdRows;
  const int s0 = (blockIdx.x % slabs) * block_cols();
  fwd_layer_tile_bf(p, blockIdx.y, a0, s0,
                    [&](long long row, int c, float h, float) {
                      out[row * d + c] =
                          active != nullptr && active[row] <= 0.f
                              ? sel_x[row * d + c] : h;
                    });
}

// The layer launch's slabs a tile and its shape at width d.
int final_layer_slabs(int d) {
  return d / (16 * fwd_warps(d, kFinalBfWarps));
}

Shape final_layer_shape(int B, int N, int d) {
  const int warps = fwd_warps(d, kFinalBfWarps);
  return {dim3((N + kBwdRows - 1) / kBwdRows * final_layer_slabs(d), B),
          warps * kWarp, fwd_layer_bf_smem_bytes(d, warps)};
}

__global__ void __launch_bounds__(256, 3) final_bwd_gru_kernel(
    Layer p, const bf16* __restrict__ wih, const bf16* __restrict__ whh,
    float* dout, float* __restrict__ dprev, float* n2_out,
    bf16* __restrict__ conv_s, bf16* __restrict__ h0g_s,
    float* __restrict__ dgi_s, float* __restrict__ dgh_s,
    float* __restrict__ dconv_s, float* __restrict__ dlp_s) {
  bwd_gru_tile_bf(p, wih, whh, dout, nullptr, dprev, n2_out, conv_s, h0g_s,
                  dgi_s, dgh_s, dconv_s, dlp_s);
}

__global__ void __launch_bounds__(256) final_bwd_input_kernel(
    const int* __restrict__ s_ptr, const int* __restrict__ s_dst,
    const int* __restrict__ s_rel, const float* __restrict__ s_em,
    const int* __restrict__ s_eid, const float* __restrict__ n2,
    const float* __restrict__ dconv_s, const float* __restrict__ dlp_s,
    const float* __restrict__ wrel, int wstride, int wcol,
    const bf16* __restrict__ loop_t, const bf16* __restrict__ x,
    float* __restrict__ ewg, float* out, int A, int d) {
  bwd_input_tile_bf(s_ptr, s_dst, s_rel, s_em, s_eid, n2, dconv_s, dlp_s,
                    wrel, wstride, wcol, loop_t, x, ewg, out, 0, 1, A, d, 0);
}

__global__ void __launch_bounds__(kWgThreads, 4) final_wgrad_kernel(
    WJobsBf jobs, int B, int A, int rows_per_split, long long part_stride) {
  wgrad_tile_bf(jobs, B, A, rows_per_split, part_stride);
}

}  // namespace

// x, loopw, wih_t, whh_t and prev bfloat16; sel_x and out float32.
extern "C" int final_layer_launch_bf16(
    const void* x, const void* rowptr, const void* src, const void* rel,
    const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* dt,
    float lam, const void* prev, const void* sel_x, const void* active,
    void* out, int B, int N, int d, void* stream) {
  if (B > 0 && N > 0) {
    const Layer p = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                               wcol, loopw, mask, 0, wih_t, whh_t, bih, bhh,
                               nullptr, nullptr, dt, lam, prev, 1, N, d, 0,
                               1);
    const Shape s = final_layer_shape(B, N, d);
    cudaError_t err = allow_smem(final_layer_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    final_layer_kernel<<<s.grid, s.threads, s.bytes,
                         static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const float*>(sel_x),
        static_cast<const float*>(active), static_cast<float*>(out),
        final_layer_slabs(d));
  }
  return static_cast<int>(cudaGetLastError());
}

// x, loopw, wih_t, whh_t, wih, whh and prev bfloat16; conv_s and h0g_s
// bfloat16 scratch.
extern "C" int final_bwd_gru_launch_bf16(
    const void* x, const void* rowptr, const void* src, const void* rel,
    const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* wih,
    const void* whh, const void* dt, float lam, const void* prev,
    const void* dout, void* dprev, void* n2_out, void* conv_s, void* h0g_s,
    void* dgi_s, void* dgh_s, void* dconv_s, void* dlp_s, int B, int N,
    int d, void* stream) {
  if (B > 0 && N > 0) {
    const Layer p = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                               wcol, loopw, mask, 0, wih_t, whh_t, bih, bhh,
                               nullptr, nullptr, dt, lam, prev, 1, N, d, 0,
                               1);
    const Shape s = bwd_gru_shape(B, N, d);
    cudaError_t err = allow_smem(final_bwd_gru_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    final_bwd_gru_kernel<<<s.grid, s.threads, s.bytes,
                           static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const bf16*>(wih), static_cast<const bf16*>(whh),
        const_cast<float*>(static_cast<const float*>(dout)),
        static_cast<float*>(dprev), static_cast<float*>(n2_out),
        static_cast<bf16*>(conv_s), static_cast<bf16*>(h0g_s),
        static_cast<float*>(dgi_s), static_cast<float*>(dgh_s),
        static_cast<float*>(dconv_s), static_cast<float*>(dlp_s));
  }
  return static_cast<int>(cudaGetLastError());
}

// loop_t and x bfloat16.
extern "C" int final_bwd_input_launch_bf16(
    const void* s_ptr, const void* s_dst, const void* s_rel,
    const void* s_em, const void* s_eid, const void* n2,
    const void* dconv_s, const void* dlp_s, const void* wrel, int wstride,
    int wcol, const void* loop_t, const void* x, void* ewg, void* out, int B,
    int N, int d, void* stream) {
  if (B > 0 && N > 0) {
    const Shape s = bwd_input_shape(B, N, d);
    cudaError_t err = allow_smem(final_bwd_input_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    final_bwd_input_kernel<<<s.grid, s.threads, s.bytes,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(s_ptr), static_cast<const int*>(s_dst),
        static_cast<const int*>(s_rel), static_cast<const float*>(s_em),
        static_cast<const int*>(s_eid), static_cast<const float*>(n2),
        static_cast<const float*>(dconv_s), static_cast<const float*>(dlp_s),
        static_cast<const float*>(wrel), wstride, wcol,
        static_cast<const bf16*>(loop_t), static_cast<const bf16*>(x),
        static_cast<float*>(ewg), static_cast<float*>(out), N, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The three weight jobs of fused_final.cu's final_wgrad_launch, their X
// operands (conv_s, h0g_s, x) bfloat16, their G operands float32; `part`
// the same float32 copies in the same layout.
extern "C" int final_wgrad_launch_bf16(
    const void* conv_s, const void* dgi_s, const void* h0g_s,
    const void* dgh_s, const void* x, const void* dlp_s, void* part,
    int n_split, int B, int N, int d, void* stream) {
  if (B > 0 && N > 0 && n_split > 0) {
    const long long sd = (long long)N * d, sg = 3LL * N * d;
    const long long dd = (long long)d * d;
    float* wih = static_cast<float*>(part);
    float* bih = wih + 3 * dd;
    float* whh = bih + 3 * d;
    float* bhh = whh + 3 * dd;
    float* loop = bhh + 3 * d;
    const long long total = (loop + dd) - wih;
    int first = 0;
    WJobsBf jobs = {};
    jobs.job[0] = make_job_bf(static_cast<const bf16*>(conv_s), sd, dgi_s,
                              sg, wih, bih, d, 3 * d, &first);
    jobs.job[1] = make_job_bf(static_cast<const bf16*>(h0g_s), sd, dgh_s,
                              sg, whh, bhh, d, 3 * d, &first);
    jobs.job[2] = make_job_bf(static_cast<const bf16*>(x), sd, dlp_s, sd,
                              loop, nullptr, d, d, &first);
    for (int j = 3; j < kWgJobs; ++j) jobs.job[j].first = kNoJob;
    cudaError_t err = allow_smem(final_wgrad_kernel, kWgSmemBytesBf);
    if (err != cudaSuccess) return static_cast<int>(err);
    final_wgrad_kernel<<<dim3(first, n_split), kWgThreads, kWgSmemBytesBf,
                         static_cast<cudaStream_t>(stream)>>>(
        jobs, B, N, wgrad_rows_per_split(B * N, n_split), total);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape and occupancy of K5's bfloat16 kernel `which` (0 its GRU
// tile, 1 its input tile, 2 its weight launch) or of K3's bfloat16 layer
// launch (3) at width d: out[0] its shared memory a block in bytes, out[1]
// its threads, out[2] the blocks an SM holds, out[3] its registers a
// thread, out[4] its local memory a thread in bytes.
extern "C" int final_bf16_occupancy(int which, int d, void* out) {
  int* o = static_cast<int*>(out);
  switch (which) {
    case 0: {
      const Shape s = bwd_gru_shape(1, 1, d);
      return static_cast<int>(
          occupancy(final_bwd_gru_kernel, s.threads, s.bytes, o, 5));
    }
    case 1: {
      const Shape s = bwd_input_shape(1, 1, d);
      return static_cast<int>(
          occupancy(final_bwd_input_kernel, s.threads, s.bytes, o, 5));
    }
    case 2:
      return static_cast<int>(occupancy(final_wgrad_kernel, kWgThreads,
                                        kWgSmemBytesBf, o, 5));
    case 3: {
      const Shape s = final_layer_shape(1, 1, d);
      return static_cast<int>(
          occupancy(final_layer_kernel, s.threads, s.bytes, o, 5));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
