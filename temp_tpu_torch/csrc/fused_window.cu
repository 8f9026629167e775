// Whole-window GRRGCN history recurrence: forward (K2f), one RGCN+GRU
// layer per launch, and backward (K2b), a few launches per layer and step.
//
// K2f replaces the TPU kernel temp_tpu/ops/fused_window.py:_fwd_kernel
// (reached through fused_window_scan, n_buf 2 or 3). For every window step
// k = 0..L1-1 and batch element b, that kernel
//   1. gathers each active row's state from its last active step
//      (gidx/live) and scales it by exp(-lambda * dt);
//   2. layer 1: takes the precomputed conv input (conv1_in, eval) or
//      computes the relational SpMM plus the self-loop product, the latter
//      times the training dropout mask when one is given (no bias, no
//      activation);
//   3. runs a GRU (torch gate order r, z, n) from the decayed state;
//   4. does the same for layer 2 over layer 1's output of step k, with a
//      ReLU on its conv output for the Bi models (act2);
//   5. writes both outputs into the [L1, A, d] buffers and, with n_buf=3,
//      layer 2's conv output after the ReLU (its "local" output, which the
//      flagship's impute blend reads) into a third.
// The backward-direction window of the Bi models is the same kernel given
// the gru_bwd weights and the backward history tables.
//
// K2b replaces temp_tpu/ops/fused_window.py:_bwd_kernel. Like it, it keeps
// only the two forward buffers and recomputes every step from them and the
// streamed masks, in reverse step order, giving the cotangents of the
// inputs, the relation weights [R, 2d], both self-loop weights and the GRU
// weights and biases of both layers. With n_buf=3 the third buffer's
// cotangent joins layer 2's conv cotangent before the ReLU's mask.
//
// What bounds both on an H100: arithmetic. Per step and element the
// forward does four [A, d] x [d, 3d] GRU gate products and one or two
// [A, d] x [d, d] self-loop products in f32; the backward recomputes them
// and adds two products per forward product (the input and the weight
// cotangents), 84 d^2 flops an active row for both layers, against a few
// MB of buffers. The SpMM parts are small. So the bound is f32 operations.
//
// What the design does about that. Step k+1 needs every row of step k,
// and layer 2 every row of layer 1's output of the same step; backward
// runs the same chain in reverse. The dependency is carried by the stream:
// the host makes one launch per layer and step forward, and five per step
// backward (layer-2 GRU, layer-2 input cotangent, layer-1 GRU, layer-1
// input cotangent, weight cotangents), each over (row tile, batch element)
// or over (weight tile, row range), and two at the end (the relation and
// the other weight cotangents' sums). No block ever waits for another
// block. The SpMMs and their transposes give one warp per row over a CSR
// of that step's edges (by destination forward, by source backward),
// summing in registers without atomics, as in spmm.cu.
// - K2f's products run on the tensor cores in 3xTF32 at f32 accuracy
//   (rgcn_gru_layer.cuh fwd_layer_tile: conv_rows_tc and gate_products on
//   tile_product, the tile K3's layer launches run too): a block takes 32 rows and a slab of the columns of every gate (kFwdWarps
//   warps of 16 columns), recomputes the tile's conv output in full (the
//   SpMM and the self-loop product, a slab at a time) and forms the gate
//   products of its slab only, so one layer's launch gives d / (16 *
//   kFwdWarps) blocks for each 32 rows: 320 at the main shape's 5,120 rows
//   and d = 128, where whole-width tiles would give 160 for 132 SMs.
// - K2b's products run on the tensor cores the same way: a GRU tile of 32
//   rows and all d columns recomputes the conv output and the gates with
//   K2f's routines and forms d_gi @ W_ih and d_gh @ W_hh with the weights
//   streamed through shared memory, each warp 16 columns of every window;
//   the input tile's d_lp @ loop^T the same way. The weight cotangents are
//   sums over all rows, steps and elements: each step's launch gives one
//   block per 64 x 64 output tile and range of
//   the step's rows, the rows as the product's depth, which adds its tile
//   into that range's own copy of the outputs; one last launch sums the
//   copies in a fixed order, so the sums are deterministic.
// The relation-weight cotangent is written per edge and summed per
// relation by one last launch over a CSR by relation. The cotangent of a
// row's previous state goes to the row of an earlier step that gidx names;
// a live row names a row no other live row names (each earlier row is read
// only by its entity's next active step), so a plain read-add-store is
// exact, and dead rows (live = 0) store nothing.
//
// The bfloat16 mode of both is a source of its own, fused_window_bf16.cu:
// the same launches on the tensor cores' native bfloat16 products
// (window_bf16.cuh), its operands staged once as bfloat16; what bounds it
// and what its design does about that are in that header's note.

#include "rgcn_gru_layer.cuh"

namespace {

// K2f's block: kFwdWarps warps (fewer where d / 16 is not a multiple of
// it), each owning 16 columns of the block's slab of every gate. Four warps
// give the main shape (d = 128) two slabs of 64 columns: 320 blocks of 128
// threads a launch over 5,120 rows, and 69,888 bytes of shared memory, so
// three blocks an SM; eight (one slab, 160 blocks) measured slower on an
// H100 (PERF.md). Each slab block redoes the tile's SpMM and self-loop (2
// d^2 of the 14 d^2 flops a row) rather than take them from a conv launch
// a layer, which would double the launches the host makes (1,288 on the
// eval sweep).
constexpr int kFwdWarps = 4;

// One RGCN+GRU layer of window step k for the rows of tile blockIdx.x /
// slabs of element blockIdx.y, at the columns of slab blockIdx.x % slabs of
// every gate: the output rows (and with loc the conv output) there, in the
// store dtype.
__global__ void __launch_bounds__(kFwdWarps * kWarp, 3) window_layer_kernel(
    Layer p, float* buf, float* loc, int slabs) {
  const int d = p.d;
  const int a0 = (blockIdx.x / slabs) * kBwdRows;
  const int s0 = (blockIdx.x % slabs) * block_cols();
  fwd_layer_tile(p, blockIdx.y, a0, s0,
                 [&](long long row, int c, float h, float conv) {
                   store_out(buf, row * d + c, h);
                   if (loc != nullptr) store_out(loc, row * d + c, conv);
                 });
}

__global__ void __launch_bounds__(256, 2) window_bwd_gru_kernel(
    Layer p, const float* __restrict__ wih, const float* __restrict__ whh,
    float* db, const float* __restrict__ g_loc, float* n2_out,
    float* __restrict__ conv_s,
    float* __restrict__ h0g_s, float* __restrict__ dgi_s,
    float* __restrict__ dgh_s, float* __restrict__ dconv_s,
    float* __restrict__ dlp_s) {
  bwd_gru_tile(p, wih, whh, db, g_loc, nullptr, n2_out, conv_s, h0g_s, dgi_s,
               dgh_s, dconv_s, dlp_s);
}

__global__ void window_bwd_input_kernel(
    const int* __restrict__ s_ptr, const int* __restrict__ s_dst,
    const int* __restrict__ s_rel, const float* __restrict__ s_em,
    const int* __restrict__ s_eid, const float* __restrict__ n2,
    const float* __restrict__ dconv_s, const float* __restrict__ dlp_s,
    const float* __restrict__ wrel, int wstride, int wcol,
    const float* __restrict__ loop_t, const float* __restrict__ x,
    float* __restrict__ ewg, float* out, int accumulate, int L1, int A,
    int d, int k) {
  bwd_input_tile(s_ptr, s_dst, s_rel, s_em, s_eid, n2, dconv_s, dlp_s, wrel,
                 wstride, wcol, loop_t, x, ewg, out, accumulate, L1, A, d, k);
}

__global__ void __launch_bounds__(kWgThreads, 4) window_wgrad_kernel(
    WJobs jobs, int B, int A,
                                    int rows_per_split,
                                    long long part_stride) {
  wgrad_tile(jobs, B, A, rows_per_split, part_stride);
}

__global__ void window_wgrad_reduce_kernel(const float* __restrict__ part,
                                           int n_split, long long total,
                                           float* __restrict__ out) {
  wgrad_reduce_one(part, n_split, total, out);
}

}  // namespace

// x_bf16: whether x is bfloat16 (the bfloat16 mode; 0 otherwise).
extern "C" int window_layer_launch(
    const void* x, int conv_given, const void* rowptr, const void* src,
    const void* rel, const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, int relu, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* gidx,
    const void* live, const void* dt, float lam, void* buf, void* loc, int B,
    int L1, int A, int d, int x_bf16, int k, void* stream) {
  if (B > 0 && A > 0) {
    const Layer p = make_layer(x, conv_given, rowptr, src, rel, em, wrel,
                               wstride, wcol, loopw, mask, relu, wih_t, whh_t,
                               bih, bhh, gidx, live, dt, lam, buf, L1, A, d,
                               k, x_bf16);
    const int warps = fwd_warps(d, kFwdWarps);
    const int slabs = d / (16 * warps);
    const int bytes =
        fwd_layer_smem_floats(d, warps) * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        window_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((A + kBwdRows - 1) / kBwdRows * slabs, B);
    window_layer_kernel<<<grid, warps * kWarp, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<float*>(buf), static_cast<float*>(loc), slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_bwd_gru_launch(
    const void* x, const void* rowptr, const void* src, const void* rel,
    const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, int relu, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* wih,
    const void* whh, const void* gidx, const void* live, const void* dt,
    float lam, const void* prev, void* db, const void* g_loc, void* n2_out,
    void* conv_s, void* h0g_s, void* dgi_s, void* dgh_s, void* dconv_s,
    void* dlp_s, int B, int L1, int A, int d, int k, void* stream) {
  if (B > 0 && A > 0) {
    const Layer p = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                               wcol, loopw, mask, relu, wih_t, whh_t, bih,
                               bhh, gidx, live, dt, lam, prev, L1, A, d, k);
    return static_cast<int>(launch_bwd_tile(
        window_bwd_gru_kernel, bwd_gru_smem_floats(d), B, A, d, stream, p,
        static_cast<const float*>(wih), static_cast<const float*>(whh),
        static_cast<float*>(db), static_cast<const float*>(g_loc),
        static_cast<float*>(n2_out), static_cast<float*>(conv_s),
        static_cast<float*>(h0g_s), static_cast<float*>(dgi_s),
        static_cast<float*>(dgh_s), static_cast<float*>(dconv_s),
        static_cast<float*>(dlp_s)));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_bwd_input_launch(
    const void* s_ptr, const void* s_dst, const void* s_rel,
    const void* s_em, const void* s_eid, const void* n2,
    const void* dconv_s, const void* dlp_s, const void* wrel, int wstride,
    int wcol, const void* loop_t, const void* x, void* ewg, void* out,
    int accumulate, int B, int L1, int A, int d, int k, void* stream) {
  if (B > 0 && A > 0) {
    return static_cast<int>(launch_bwd_tile(
        window_bwd_input_kernel, bwd_input_smem_floats(d), B, A, d, stream,
        static_cast<const int*>(s_ptr), static_cast<const int*>(s_dst),
        static_cast<const int*>(s_rel), static_cast<const float*>(s_em),
        static_cast<const int*>(s_eid), static_cast<const float*>(n2),
        static_cast<const float*>(dconv_s), static_cast<const float*>(dlp_s),
        static_cast<const float*>(wrel), wstride, wcol,
        static_cast<const float*>(loop_t), static_cast<const float*>(x),
        static_cast<float*>(ewg), static_cast<float*>(out), accumulate, L1,
        A, d, k));
  }
  return static_cast<int>(cudaGetLastError());
}

// The six weight jobs of step k: (conv2, d_gi2) -> dwih2 + dbih2,
// (h0g2, d_gh2) -> dwhh2 + dbhh2, (buf1[k], d_lp2) -> dloop2, and the same
// for layer 1 with h0x[k] as the self-loop input. `part` holds n_split
// copies of the flat outputs, each laid out as wih2 [d, 3d], bih2 [3d],
// whh2 [d, 3d], bhh2 [3d], loop2 [d, d], then the same for layer 1.
extern "C" int window_wgrad_launch(
    const void* conv2, const void* h0g2, const void* buf1, const void* dgi2,
    const void* dgh2, const void* dlp2, const void* conv1, const void* h0g1,
    const void* h0x, const void* dgi1, const void* dgh1, const void* dlp1,
    void* part, int n_split, int B, int L1, int A, int d, int k,
    void* stream) {
  if (B > 0 && A > 0 && n_split > 0) {
    const long long sd = (long long)A * d, sg = 3LL * A * d;
    const long long win = (long long)L1 * A * d, off = (long long)k * A * d;
    const float* b1 = static_cast<const float*>(buf1) + off;
    const float* h0 = static_cast<const float*>(h0x) + off;
    const long long dd = (long long)d * d;
    float* o = static_cast<float*>(part);
    float* wih2 = o;
    float* bih2 = wih2 + 3 * dd;
    float* whh2 = bih2 + 3 * d;
    float* bhh2 = whh2 + 3 * dd;
    float* loop2 = bhh2 + 3 * d;
    float* wih1 = loop2 + dd;
    float* bih1 = wih1 + 3 * dd;
    float* whh1 = bih1 + 3 * d;
    float* bhh1 = whh1 + 3 * dd;
    float* loop1 = bhh1 + 3 * d;
    const long long total = (loop1 + dd) - o;
    int first = 0;
    WJobs jobs;
    jobs.job[0] = make_job(conv2, sd, dgi2, sg, wih2, bih2, d, 3 * d, &first);
    jobs.job[1] = make_job(h0g2, sd, dgh2, sg, whh2, bhh2, d, 3 * d, &first);
    jobs.job[2] = make_job(b1, win, dlp2, sd, loop2, nullptr, d, d, &first);
    jobs.job[3] = make_job(conv1, sd, dgi1, sg, wih1, bih1, d, 3 * d, &first);
    jobs.job[4] = make_job(h0g1, sd, dgh1, sg, whh1, bhh1, d, 3 * d, &first);
    jobs.job[5] = make_job(h0, win, dlp1, sd, loop1, nullptr, d, d, &first);
    return static_cast<int>(launch_wgrad(window_wgrad_kernel, jobs, first,
                                         n_split, B, A, total, stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// The sums below read and write float32 only: they serve both modes.
extern "C" int window_wgrad_reduce_launch(const void* part, int n_split,
                                          long long total, void* out,
                                          void* stream) {
  if (total > 0) {
    const int threads = 256;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    window_wgrad_reduce_kernel<<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part), n_split, total,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_rel_grad_launch(const void* r_ptr, const void* r_eid,
                                      const void* ewg1, const void* ewg2,
                                      void* dwrel, int n_rels, int d,
                                      void* stream) {
  return static_cast<int>(
      rel_sum(r_ptr, r_eid, ewg1, ewg2, dwrel, n_rels, d, stream));
}

// The launch shape and occupancy of window kernel `which` (0 K2f's layer,
// 1 K2b's GRU tile, 2 its input tile, 3 its weight launch) at width d:
// out[0] its shared memory a block in bytes, out[1] its threads, out[2] the
// blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <typename K>
static cudaError_t window_occupancy_of(K kernel, int threads, int bytes,
                                       int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, bytes);
  out[0] = bytes;
  out[1] = threads;
  out[2] = blocks;
  return err;
}

extern "C" int window_occupancy(int which, int d, void* out) {
  int* o = static_cast<int*>(out);
  const int fl = static_cast<int>(sizeof(float));
  switch (which) {
    case 0: {
      const int warps = fwd_warps(d, kFwdWarps);
      return static_cast<int>(window_occupancy_of(
          window_layer_kernel, warps * kWarp,
          fwd_layer_smem_floats(d, warps) * fl, o));
    }
    case 1:
      return static_cast<int>(window_occupancy_of(
          window_bwd_gru_kernel, 2 * d, bwd_gru_smem_floats(d) * fl, o));
    case 2:
      return static_cast<int>(window_occupancy_of(
          window_bwd_input_kernel, 2 * d, bwd_input_smem_floats(d) * fl, o));
    case 3:
      return static_cast<int>(window_occupancy_of(
          window_wgrad_kernel, kWgThreads, kWgSmemBytes, o));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
