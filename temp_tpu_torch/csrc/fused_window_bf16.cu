// K2f and K2b in their bfloat16 mode, on the tensor cores' native bfloat16
// products (window_bf16.cuh says what the mode computes and how). Replaces
// the bfloat16 instantiation of temp_tpu/ops/fused_window.py:_fwd_kernel
// and _bwd_kernel. The launches and their order are fused_window.cu's (its
// note describes them), each exported with the suffix _bf16 and the same
// arguments; what differs:
// - the operands: the layer's input x is bfloat16 in every launch (layer
//   1's rows rounded once by the wrapper, layer 2's layer 1's buffer), and
//   loopw, wih_t, whh_t (and K2b's wih, whh, loop_t) are the wrapper's
//   bfloat16 copies of the weights; the relation weights, masks, biases
//   and every cotangent float32; K2b's conv_s and h0g_s scratch bfloat16
//   (read only rounded), the weight launch's buf1 and h0x bfloat16;
// - K2f (window_layer_kernel): 32-row tiles by slabs of 64 columns of every
//   gate, as in float32: 320 blocks of 128 threads over the main shape's
//   5,120 rows (d = 128), each 73,216 bytes of shared memory (69,888 in
//   float32), three blocks an SM; 32 k16 steps a block (two self-loop
//   slabs of 8, the two gate products 8 each) in 16 ring slots, so 16
//   barriers where the k8 design had 64 (slots of 16 rows, 32 barriers
//   and 54,016 bytes for four blocks an SM, measured 9% slower);
// - K2b's GRU tile (window_bwd_gru_kernel): 16-row tiles of d / 16 warps
//   (320 blocks of 256 threads at the main shape, 32 rows and 160 blocks in
//   float32), 68,096 bytes (103,680), three blocks an SM (its registers'
//   bound too), so every block of a launch resident at once; ring slots of
//   16 rows for its gate products, 32 for the rest; its input tile 32 rows
//   as before (160 blocks of 256 threads), 51,712 bytes, four an SM; its
//   weight launch float32's tiles and ranges (56 tiles by 8 ranges, 448
//   blocks of 128 threads), 50,688 bytes, four an SM.
// No atomics; the sums across blocks go to per-range copies reduced in a
// fixed order by the float32 build's reduction, so runs repeat bit for bit.

#define TK_BF16 1
#include "rgcn_gru_layer.cuh"
#include "window_bf16.cuh"

namespace {

constexpr int kFwdWarps = 4;

__global__ void __launch_bounds__(kFwdWarps * kWarp, 3) window_layer_kernel(
    Layer p, float* buf, float* loc, int slabs) {
  const int d = p.d;
  const int a0 = (blockIdx.x / slabs) * kBwdRows;
  const int s0 = (blockIdx.x % slabs) * block_cols();
  fwd_layer_tile_bf(p, blockIdx.y, a0, s0,
                    [&](long long row, int c, float h, float conv) {
                      store_out(buf, row * d + c, h);
                      if (loc != nullptr) store_out(loc, row * d + c, conv);
                    });
}

__global__ void __launch_bounds__(256, 3) window_bwd_gru_kernel(
    Layer p, const bf16* __restrict__ wih, const bf16* __restrict__ whh,
    float* db, const float* __restrict__ g_loc, float* n2_out,
    bf16* __restrict__ conv_s, bf16* __restrict__ h0g_s,
    float* __restrict__ dgi_s, float* __restrict__ dgh_s,
    float* __restrict__ dconv_s, float* __restrict__ dlp_s) {
  bwd_gru_tile_bf(p, wih, whh, db, g_loc, nullptr, n2_out, conv_s, h0g_s,
                  dgi_s, dgh_s, dconv_s, dlp_s);
}

__global__ void __launch_bounds__(256) window_bwd_input_kernel(
    const int* __restrict__ s_ptr, const int* __restrict__ s_dst,
    const int* __restrict__ s_rel, const float* __restrict__ s_em,
    const int* __restrict__ s_eid, const float* __restrict__ n2,
    const float* __restrict__ dconv_s, const float* __restrict__ dlp_s,
    const float* __restrict__ wrel, int wstride, int wcol,
    const bf16* __restrict__ loop_t, const bf16* __restrict__ x,
    float* __restrict__ ewg, float* out, int accumulate, int L1, int A,
    int d, int k) {
  bwd_input_tile_bf(s_ptr, s_dst, s_rel, s_em, s_eid, n2, dconv_s, dlp_s,
                    wrel, wstride, wcol, loop_t, x, ewg, out, accumulate, L1,
                    A, d, k);
}

__global__ void __launch_bounds__(kWgThreads, 4) window_wgrad_kernel(
    WJobsBf jobs, int B, int A, int rows_per_split, long long part_stride) {
  wgrad_tile_bf(jobs, B, A, rows_per_split, part_stride);
}

// K2f's launch shape at width d, for A rows a step and B elements.
Shape layer_shape(int B, int A, int d) {
  const int warps = fwd_warps(d, kFwdWarps);
  const int slabs = d / (16 * warps);
  return {dim3((A + kBwdRows - 1) / kBwdRows * slabs, B), warps * kWarp,
          fwd_layer_bf_smem_bytes(d, warps)};
}

}  // namespace

// x_bf16 must be 1: this mode reads every layer's input as bfloat16.
extern "C" int window_layer_launch_bf16(
    const void* x, int conv_given, const void* rowptr, const void* src,
    const void* rel, const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, int relu, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* gidx,
    const void* live, const void* dt, float lam, void* buf, void* loc, int B,
    int L1, int A, int d, int x_bf16, int k, void* stream) {
  if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && A > 0) {
    const Layer p = make_layer(x, conv_given, rowptr, src, rel, em, wrel,
                               wstride, wcol, loopw, mask, relu, wih_t, whh_t,
                               bih, bhh, gidx, live, dt, lam, buf, L1, A, d,
                               k, 1);
    const Shape s = layer_shape(B, A, d);
    const int slabs = d / (16 * fwd_warps(d, kFwdWarps));
    cudaError_t err = allow_smem(window_layer_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_layer_kernel<<<s.grid, s.threads, s.bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<float*>(buf), static_cast<float*>(loc), slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (bfloat16), loopw, wih_t, whh_t, wih and whh the bfloat16 operands;
// conv_s and h0g_s bfloat16 scratch.
extern "C" int window_bwd_gru_launch_bf16(
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
                               bhh, gidx, live, dt, lam, prev, L1, A, d, k,
                               1);
    const Shape s = bwd_gru_shape(B, A, d);
    cudaError_t err = allow_smem(window_bwd_gru_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_bwd_gru_kernel<<<s.grid, s.threads, s.bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const bf16*>(wih), static_cast<const bf16*>(whh),
        static_cast<float*>(db), static_cast<const float*>(g_loc),
        static_cast<float*>(n2_out), static_cast<bf16*>(conv_s),
        static_cast<bf16*>(h0g_s), static_cast<float*>(dgi_s),
        static_cast<float*>(dgh_s), static_cast<float*>(dconv_s),
        static_cast<float*>(dlp_s));
  }
  return static_cast<int>(cudaGetLastError());
}

// loop_t and x bfloat16.
extern "C" int window_bwd_input_launch_bf16(
    const void* s_ptr, const void* s_dst, const void* s_rel,
    const void* s_em, const void* s_eid, const void* n2,
    const void* dconv_s, const void* dlp_s, const void* wrel, int wstride,
    int wcol, const void* loop_t, const void* x, void* ewg, void* out,
    int accumulate, int B, int L1, int A, int d, int k, void* stream) {
  if (B > 0 && A > 0) {
    const Shape s = bwd_input_shape(B, A, d);
    cudaError_t err = allow_smem(window_bwd_input_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_bwd_input_kernel<<<s.grid, s.threads, s.bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(s_ptr), static_cast<const int*>(s_dst),
        static_cast<const int*>(s_rel), static_cast<const float*>(s_em),
        static_cast<const int*>(s_eid), static_cast<const float*>(n2),
        static_cast<const float*>(dconv_s), static_cast<const float*>(dlp_s),
        static_cast<const float*>(wrel), wstride, wcol,
        static_cast<const bf16*>(loop_t), static_cast<const bf16*>(x),
        static_cast<float*>(ewg), static_cast<float*>(out), accumulate, L1,
        A, d, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// The six weight jobs of step k, as fused_window.cu's: the X operands
// (conv2, h0g2, buf1, conv1, h0g1, h0x) bfloat16, the G operands float32;
// `part` the same float32 copies in the same layout.
extern "C" int window_wgrad_launch_bf16(
    const void* conv2, const void* h0g2, const void* buf1, const void* dgi2,
    const void* dgh2, const void* dlp2, const void* conv1, const void* h0g1,
    const void* h0x, const void* dgi1, const void* dgh1, const void* dlp1,
    void* part, int n_split, int B, int L1, int A, int d, int k,
    void* stream) {
  if (B > 0 && A > 0 && n_split > 0) {
    const long long sd = (long long)A * d, sg = 3LL * A * d;
    const long long win = (long long)L1 * A * d, off = (long long)k * A * d;
    const bf16* b1 = static_cast<const bf16*>(buf1) + off;
    const bf16* h0 = static_cast<const bf16*>(h0x) + off;
    const bf16* c2 = static_cast<const bf16*>(conv2);
    const bf16* g2 = static_cast<const bf16*>(h0g2);
    const bf16* c1 = static_cast<const bf16*>(conv1);
    const bf16* g1 = static_cast<const bf16*>(h0g1);
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
    WJobsBf jobs;
    jobs.job[0] = make_job_bf(c2, sd, dgi2, sg, wih2, bih2, d, 3 * d, &first);
    jobs.job[1] = make_job_bf(g2, sd, dgh2, sg, whh2, bhh2, d, 3 * d, &first);
    jobs.job[2] = make_job_bf(b1, win, dlp2, sd, loop2, nullptr, d, d,
                              &first);
    jobs.job[3] = make_job_bf(c1, sd, dgi1, sg, wih1, bih1, d, 3 * d, &first);
    jobs.job[4] = make_job_bf(g1, sd, dgh1, sg, whh1, bhh1, d, 3 * d, &first);
    jobs.job[5] = make_job_bf(h0, win, dlp1, sd, loop1, nullptr, d, d,
                              &first);
    cudaError_t err = allow_smem(window_wgrad_kernel, kWgSmemBytesBf);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_wgrad_kernel<<<dim3(first, n_split), kWgThreads, kWgSmemBytesBf,
                          static_cast<cudaStream_t>(stream)>>>(
        jobs, B, A, wgrad_rows_per_split(B * A, n_split), total);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape and occupancy of window kernel `which` (0 K2f's layer,
// 1 K2b's GRU tile, 2 its input tile, 3 its weight launch) at width d:
// out[0] its shared memory a block in bytes, out[1] its threads, out[2] the
// blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int window_occupancy_bf16(int which, int d, void* out) {
  int* o = static_cast<int*>(out);
  switch (which) {
    case 0: {
      const Shape s = layer_shape(1, 1, d);
      return static_cast<int>(
          occupancy(window_layer_kernel, s.threads, s.bytes, o));
    }
    case 1: {
      const Shape s = bwd_gru_shape(1, 1, d);
      return static_cast<int>(
          occupancy(window_bwd_gru_kernel, s.threads, s.bytes, o));
    }
    case 2: {
      const Shape s = bwd_input_shape(1, 1, d);
      return static_cast<int>(
          occupancy(window_bwd_input_kernel, s.threads, s.bytes, o));
    }
    case 3:
      return static_cast<int>(
          occupancy(window_wgrad_kernel, kWgThreads, kWgSmemBytesBf, o));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
