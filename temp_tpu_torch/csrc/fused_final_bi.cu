// The flagship's final step (BiGRRGCN with imputation) for a batch of B
// target snapshots: the bidirectional layer forward (K6+K7) and its backward
// (K9+K10). The loss from the table (K8) and its backward (K4) run the
// launches of fused_final.cu on the bidirectional table.
//
// K6+K7 replace the TPU kernels temp_tpu/ops/fused_final_bi.py:
// _conv_fwd_bi_kernel (the edge part of one layer: the relational SpMM with
// the double degree norm over the encoder's 50% edge subsample plus the
// self-loop product times its dropout mask) and _gru_fwd_bi_kernel (the row
// part: layer 2's ReLU; on layer 2's inactive rows the impute blend
// w_dir = exp(-max(w_dir * dt_dir + b_dir, 0)) / 2,
// gin = w_f * hloc_f + w_b * hloc_b + (1 - w_f - w_b) * conv; then
// GRU_f(gin, h_f * exp(-lambda dt_f)) + GRU_b(gin, h_b * exp(-lambda dt_b))).
// The TPU split the two into programs because one program's [N, d]
// intermediates did not fit its VMEM (fused_final_bi.py:22-42); here both
// are one launch a layer over (row tile, element), built on the window's
// tile code (rgcn_gru_layer.cuh): the tile's conv output never leaves shared
// memory. Layer 2 may also apply use_embed_for_non_active's select.
//
// K9+K10 replace _gru_bwd_bi_kernel and _conv_bwd_bi_kernel: bi_bwd_gru
// recomputes the layer's conv output, blend and both GRUs' gates for a tile,
// takes the output cotangent (one for both GRUs: rec = rec_f + rec_b), and
// gives both previous states' cotangents, both local rows' cotangents, each
// row's four impute-scalar terms, and the conv cotangent (through the
// ReLU's mask) with the gate cotangents and their product operands for the
// weight launch. Then K5's launches: the input cotangent with per-edge
// relation cotangents (final_bwd_input), the weight cotangents of both GRUs,
// the self-loop and the four impute scalars as sums over the B*N rows in 16
// ranges (bi_wgrad, the window's weight tiles with six jobs), their ordered
// sum, and the relation sum. Layer 1 runs without the ReLU and the blend.
//
// Compiled a second time as fused_final_bi_bf16.cu, with TK_BF16 1, for
// the helpers that source's own K6+K7 and K9+K10 share with this one
// (BiRows, gin_at, local_at: both directions' histories and both local
// tables are bfloat16 in device memory there, widened to float32 as the
// TPU kernels' casts do); both kernels' bfloat16 modes are that source's,
// on window_bf16.cuh, and this source's kernels and launchers are float32
// only. K8 and K4 are then K3's and K4's launches in their bfloat16 mode
// (fused_final_bf16.cu).
//
// What bounds them on an H100: arithmetic. Per layer and element the
// forward does the self-loop product (2 N d^2 flops) and four [N, d] x
// [d, 3d] gate products (24 N d^2); the backward recomputes them and adds
// the input and weight cotangent products of both GRUs and the self-loop
// (52 N d^2). The history, local and mask rows are a few hundred MB a step,
// below that at 67 TFLOP/s.
//
// What the design does about that: one launch covers the batch (b in the
// grid), and every product runs on the tensor cores in 3xTF32 at f32
// accuracy (rgcn_gru_layer.cuh). bi_layer_kernel and bi_bwd_gru_kernel
// work on the same 32-row tiles of d / 16 warps and the same shared-memory
// regions (bi_tile_smem_floats: two blocks an SM at d = 128), and form the
// conv output (conv_rows_tc), the GRU input (gin_at) and both directions'
// gates (gate_products) with the same routines, so the backward's
// float32 recompute equals the forward bit for bit; bi_bwd_gru_kernel's ten
// products go through tile_product, as K5's GRU tile; the input launch is
// K5's, the weight launch wgrad_tile's. No atomics: every sum over rows
// goes through per-range partials and an ordered reduction, so runs repeat
// bit for bit.

#include <math.h>

#include "rgcn_gru_layer.cuh"

namespace {

// What a bidirectional layer needs besides its two directions' Layer
// structs (the forward GRU with prev_f/dt_f, the backward one with
// prev_b/dt_b; both with the same conv fields).
struct BiRows {
  const float* active;  // [B, N] > 0 where the entity is active
  const float* hl_f;    // [B, N, d] local rows of the forward window, or null
                        // (no impute blend); bfloat16 in the bfloat16 mode
  const float* hl_b;    // [B, N, d]
  const float* imp;     // [4]: w_f, b_f, w_b, b_b
  const float* sel_x;   // [B, N, d] rows kept where inactive, or null
};

__device__ __forceinline__ float impute_weight(float w, float bias, float dt) {
  return expf(-fmaxf(w * dt + bias, 0.f)) * 0.5f;
}

// Element e of a local table (K2's third buffer, densified): bfloat16 in
// the bfloat16 mode, float otherwise.
__device__ __forceinline__ float local_at(const float* base, long long e) {
  if constexpr (kBf16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[e]);
  else
    return base[e];
}

// The GRU input of row `row` at element e of the [B, N, d] rows, from its
// conv output cv: cv on an active row or without the blend, else
// w_f * hl_f + w_b * hl_b + (1 - w_f - w_b) * cv. The forward and the
// backward's recompute both form it here.
__device__ __forceinline__ float gin_at(const Layer& pf, const Layer& pb,
                                        const BiRows& q, long long row,
                                        long long e, float cv) {
  if (q.hl_f == nullptr || q.active[row] > 0.f) return cv;
  const float wf = impute_weight(q.imp[0], q.imp[1], pf.dt[row]);
  const float wb = impute_weight(q.imp[2], q.imp[3], pb.dt[row]);
  return wf * local_at(q.hl_f, e) + wb * local_at(q.hl_b, e)
         + (1.f - wf - wb) * cv;
}

// K6+K7 and K9+K10 in float32 only: their bfloat16 mode is
// fused_final_bi_bf16.cu's own native kernels (window_bf16.cuh).
#if !TK_BF16

// Shared memory of the bidirectional tiles in floats: the ring of three
// gate windows, then four [kBwdRows, d + 4] regions: xs (the input rows),
// hf, hb (the two directions' decayed states) and cs (the GRU input).
// bi_layer_kernel parks the forward direction's output in xs, dead after
// the conv. In bi_bwd_gru_kernel, once a direction's states are dead, its
// gate cotangents go over the first three regions, three gate sections at
// a time ([kBwdRows, 3d + 4]: d_r, d_z, d_n, then d_ghn), and at the end the
// impute sums' scratch. 105,216 bytes at d = 128: two blocks an SM, where
// one [kBwdRows, 4d + 4] region for all four sections and a copy of the
// conv output (188,160 bytes) would leave room for one.
__host__ __device__ constexpr int bi_tile_smem_floats(int d) {
  return ring_floats(3, d) + 4 * kBwdRows * (d + 4);
}

// One bidirectional layer forward for a tile of kBwdRows rows (blockIdx.x)
// of element blockIdx.y, with d / 16 warps: the input rows and the forward
// direction's decayed states (load_tile), the backward direction's states
// copied while the conv runs (copy_prev, decay_prev), the conv output on the
// tensor cores (conv_rows_tc), the GRU input at the threads' own positions
// (gin_at; the next product's opening barrier publishes it), then each
// direction's gates (gate_products) and GRU output. The forward
// direction's output waits in xs at the thread's own positions, so no
// accumulator lives across the backward direction's products. Writes the
// sum of the two GRUs, or on an inactive row sel_x's when it is not null;
// with gin_out also the GRU input, for holding it to K9+K10's recompute.
__global__ void __launch_bounds__(256, 2) bi_layer_kernel(
    Layer pf, Layer pb, BiRows q, float* __restrict__ out,
    float* __restrict__ gin_out) {   // [B*N, d] the GRU input, or null
  extern __shared__ float smem[];
  const int d = pf.d, N = pf.A, ld = d + 4;
  float* ring = smem;
  float* xs = smem + ring_floats(3, d);
  float* hf = xs + kBwdRows * ld;
  float* hb = hf + kBwdRows * ld;
  float* cs = hb + kBwdRows * ld;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kBwdRows;
  const int c0 = warp_col0();
  load_tile(pf, b, a0, kBwdRows, ld, xs, nullptr, hf);
  copy_prev(pb, b, a0, kBwdRows, ld, hb);
  conv_rows_tc(pf, b, a0, xs, cs, ld, ring, nullptr);
  decay_prev(pb, b, a0, kBwdRows, ld, hb);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        if (a >= N) continue;
        const long long row = (long long)b * N + a;
        const long long e = row * d + c;
        const float gv = gin_at(pf, pb, q, row, e, cs[r * ld + c]);
        cs[r * ld + c] = gv;
        if (gin_out != nullptr) gin_out[e] = gv;
      }

  float acc[4][kMTiles][2][4];
  gate_products(cs, hf, ld, pf.wih_t, pf.whh_t, d, 0, ring, acc);
  {
    const GateBias gb = gate_bias(pf.bih, pf.bhh, d, c0);
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(mt, i), c = c0 + acc_col(nt, i);
          const GateAt g = gate_at(acc, mt, nt, i, gb);
          xs[r * ld + c] = (1.f - g.z) * g.n + g.z * hf[r * ld + c];
        }
  }
  gate_products(cs, hb, ld, pb.wih_t, pb.whh_t, d, 0, ring, acc);
  const GateBias gb = gate_bias(pb.bih, pb.bhh, d, c0);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        if (a >= N) continue;
        const long long row = (long long)b * N + a;
        const GateAt g = gate_at(acc, mt, nt, i, gb);
        float v = xs[r * ld + c]
                  + ((1.f - g.z) * g.n + g.z * hb[r * ld + c]);
        if (q.sel_x != nullptr && !(q.active[row] > 0.f))
          v = q.sel_x[row * d + c];
        out[row * d + c] = v;
      }
}

// One direction's GRU backward for the tile: its gates from the GRU input
// cs and its decayed states hs (gate_products), the gate cotangents into
// the step scratch (with h0g), d_gi @ W_ih and d_gh @ W_hh through
// tile_product (their A operand the sections [d_r | d_z | d_n], then
// d_ghn, in dg, row stride ldg; dg overlays hs: a barrier parts the two),
// the previous state's cotangent into dprev, and d_gi @ W_ih into dgin at
// the thread's own positions, added to what is there when `add` (the
// second direction: dgin holds the first's, so no accumulator lives across
// the second direction's gate products). d_out * z waits in dprev at the
// thread's own positions until the products are done.
__device__ __forceinline__ void bi_direction_bwd(
    const Layer& p, const float* __restrict__ wih,
    const float* __restrict__ whh, const float* cs, const float* hs,
    float* dg, int ldg, float* ring, int b, int a0,
    const float* __restrict__ dout, float* __restrict__ h0g_s,
    float* __restrict__ dgi_s, float* __restrict__ dgh_s,
    float* __restrict__ dprev, float* dgin, bool add) {
  const int d = p.d, N = p.A, d3 = 3 * d, ld = d + 4;
  const int c0 = warp_col0();
  float acc[4][kMTiles][2][4];
  gate_products(cs, hs, ld, p.wih_t, p.whh_t, d, 0, ring, acc);
  const GateBias gb = gate_bias(p.bih, p.bhh, d, c0);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        float pr = 0.f, pz = 0.f, pn = 0.f, phn = 0.f;
        if (a < N) {
          const long long m = (long long)b * N + a;
          const GateAt g = gate_at(acc, mt, nt, i, gb);
          const float dv = dout[m * d + c];
          const float h = hs[r * ld + c];
          const float dz = dv * (h - g.n);
          const float dn = dv * (1.f - g.z);
          dprev[m * d + c] = dv * g.z;
          pn = dn * (1.f - g.n * g.n);
          phn = pn * g.r;
          pr = pn * g.ghn * g.r * (1.f - g.r);
          pz = dz * g.z * (1.f - g.z);
          h0g_s[m * d + c] = h;
          dgi_s[m * d3 + c] = pr;
          dgi_s[m * d3 + d + c] = pz;
          dgi_s[m * d3 + 2 * d + c] = pn;
          dgh_s[m * d3 + c] = pr;
          dgh_s[m * d3 + d + c] = pz;
          dgh_s[m * d3 + 2 * d + c] = phn;
        }
        acc[0][mt][nt][i] = pr;
        acc[1][mt][nt][i] = pz;
        acc[2][mt][nt][i] = pn;
        acc[3][mt][nt][i] = phn;
      }
  __syncthreads();                     // dg overwrites hs
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dg[acc_row(mt, i) * ldg + j * d + c0 + acc_col(nt, i)] =
              acc[j][mt][nt][i];
  float dacc[2][kMTiles][2][4];        // d_gi @ W_ih, d_gh @ W_hh
  zero_acc(dacc);
  {
    // [d_r | d_z] against the r and z rows of both weights (depth 2d), d_n
    // against W_ih's n rows
    const float* wrz[2] = {wih, whh};
    tile_product<2, 0, 1>(dg, ldg, 2 * d, wrz, d, d, ring, dacc);
    const float* wn[1] = {wih + 2LL * d * d};
    tile_product<2, 0>(dg + 2 * d, ldg, d, wn, d, d, ring, dacc);
  }
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dg[acc_row(mt, i) * ldg + c0 + acc_col(nt, i)] = acc[3][mt][nt][i];
  {
    const float* wh[1] = {whh + 2LL * d * d};
    tile_product<2, 1>(dg, ldg, d, wh, d, d, ring, dacc);
  }
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = a0 + acc_row(mt, i), c = c0 + acc_col(nt, i);
        if (a >= N) continue;
        const long long row = (long long)b * N + a;
        const long long e = row * d + c;
        dprev[e] = (dprev[e] + dacc[1][mt][nt][i])
                   * expf(-p.lam * p.dt[row]);
        dgin[e] = add ? dgin[e] + dacc[0][mt][nt][i] : dacc[0][mt][nt][i];
      }
}

// Backward of one bidirectional layer's row part for a tile of kBwdRows
// rows (blockIdx.x) of element blockIdx.y, with d / 16 warps: the conv
// output recomputed on the tensor cores (conv_rows_tc), the blend on the
// inactive rows, then each direction in turn (bi_direction_bwd), then the
// input's cotangent through the blend and the ReLU and the impute terms.
// The conv output before the blend, which the impute terms read at the
// end, waits in dconv_s at the thread's own positions (written and read by
// the same thread; dconv_s takes its own value last); the ReLU's signs in
// a register. So the tile keeps at most the gates, or a direction's gate
// cotangents and products, in registers. With relu_out it also writes the
// ReLU's pattern (1 where it passes) for holding the kernel to its plain
// version.
__global__ void __launch_bounds__(256, 2) bi_bwd_gru_kernel(
    Layer pf, Layer pb, BiRows q,
    const float* __restrict__ wih_f,   // [3d, d] (torch layout)
    const float* __restrict__ whh_f, const float* __restrict__ wih_b,
    const float* __restrict__ whh_b,
    const float* __restrict__ dout,    // [B, N, d]
    float* __restrict__ dprev_f, float* __restrict__ dprev_b,
    float* __restrict__ dhl_f,         // [B, N, d], or null without impute
    float* __restrict__ dhl_b,
    float* __restrict__ dimp_rows,     // [B*N, 4], or null without impute
    float* __restrict__ n2_out,        // [B*N]
    float* __restrict__ gin_s,         // [B*N, d]
    float* __restrict__ h0f_s, float* __restrict__ h0b_s,
    float* __restrict__ dgi_f, float* __restrict__ dgh_f,  // [B*N, 3d]
    float* __restrict__ dgi_b, float* __restrict__ dgh_b,
    float* __restrict__ dconv_s,       // [B*N, d]
    float* __restrict__ dlp_s,
    float* __restrict__ relu_out) {    // [B*N, d] the ReLU's pattern, or null
  extern __shared__ float smem[];
  const int d = pf.d, N = pf.A, ld = d + 4, ldg = 3 * d + 4;
  float* ring = smem;
  float* xs = smem + ring_floats(3, d);
  float* hf = xs + kBwdRows * ld;
  float* hb = hf + kBwdRows * ld;
  float* cs = hb + kBwdRows * ld;
  float* dg = xs;                      // over xs, hf and hb
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kBwdRows;
  const int c0 = warp_col0();
  const bool impute = q.hl_f != nullptr;
  load_tile(pf, b, a0, kBwdRows, ld, xs, nullptr, hf);
  conv_rows_tc(pf, b, a0, xs, cs, ld, ring, n2_out);
  // the blend, at the thread's own positions of the conv output
  unsigned pos_bits = 0;               // conv output > 0, by position
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        const float cv = cs[r * ld + c];
        if (cv > 0.f) pos_bits |= 1u << ((mt * 2 + nt) * 4 + i);
        if (a >= N) continue;
        const long long row = (long long)b * N + a;
        const long long e = row * d + c;
        if (relu_out != nullptr)
          relu_out[e] = !pf.relu || cv > 0.f ? 1.f : 0.f;
        if (impute) dconv_s[e] = cv;
        const float gv = gin_at(pf, pb, q, row, e, cv);
        cs[r * ld + c] = gv;
        gin_s[e] = gv;
      }

  // d_gin = d_gi_f @ W_ih_f + d_gi_b @ W_ih_b waits in dlp_s (which takes
  // its own value last) at the thread's own positions
  bi_direction_bwd(pf, wih_f, whh_f, cs, hf, dg, ldg, ring, b, a0, dout,
                   h0f_s, dgi_f, dgh_f, dprev_f, dlp_s, false);
  // the backward direction's states, into the region the products have
  // left (the last one ended with a barrier)
  copy_prev(pb, b, a0, kBwdRows, ld, hb);
  decay_prev(pb, b, a0, kBwdRows, ld, hb);
  bi_direction_bwd(pb, wih_b, whh_b, cs, hb, dg, ldg, ring, b, a0, dout,
                   h0b_s, dgi_b, dgh_b, dprev_b, dlp_s, true);

  // the input's cotangent through the blend and the ReLU; the impute
  // terms' rows into xs and hf (free since the last product's barrier)
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        float pfv = 0.f, pbv = 0.f;
        if (a < N) {
          const long long row = (long long)b * N + a;
          const long long e = row * d + c;
          const float dxv = dlp_s[e];
          float dc = dxv;
          if (impute) {
            float hlf = 0.f, hlb = 0.f;
            if (!(q.active[row] > 0.f)) {
              const float wf = impute_weight(q.imp[0], q.imp[1], pf.dt[row]);
              const float wb = impute_weight(q.imp[2], q.imp[3], pb.dt[row]);
              const float cv = dconv_s[e];
              hlf = wf * dxv;
              hlb = wb * dxv;
              pfv = dxv * (local_at(q.hl_f, e) - cv);
              pbv = dxv * (local_at(q.hl_b, e) - cv);
              dc = (1.f - wf - wb) * dxv;
            }
            dhl_f[e] = hlf;
            dhl_b[e] = hlb;
          }
          if (pf.relu && !((pos_bits >> ((mt * 2 + nt) * 4 + i)) & 1u))
            dc = 0.f;
          dconv_s[e] = dc;
          dlp_s[e] = pf.mask != nullptr ? dc * pf.mask[e] : dc;
        }
        xs[r * ld + c] = pfv;
        hf[r * ld + c] = pbv;
      }
  if (!impute) return;
  __syncthreads();

  // each row's impute terms: d w_dir / d a_dir = -w_dir where a_dir > 0
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int r = warp; r < kBwdRows; r += nwarps) {
    float sf = 0.f, sb = 0.f;
    for (int c = lane; c < d; c += kWarp) {
      sf += xs[r * ld + c];
      sb += hf[r * ld + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sf += __shfl_xor_sync(0xffffffffu, sf, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    const int a = a0 + r;
    if (lane == 0 && a < N) {
      const long long row = (long long)b * N + a;
      const float dtf = pf.dt[row], dtb = pb.dt[row];
      const float af = q.imp[0] * dtf + q.imp[1];
      const float ab = q.imp[2] * dtb + q.imp[3];
      const float daf = af > 0.f ? -impute_weight(q.imp[0], q.imp[1], dtf) * sf
                                 : 0.f;
      const float dab = ab > 0.f ? -impute_weight(q.imp[2], q.imp[3], dtb) * sb
                                 : 0.f;
      float* o = dimp_rows + row * 4;
      o[0] = daf * dtf;
      o[1] = daf;
      o[2] = dab * dtb;
      o[3] = dab;
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 4) bi_wgrad_kernel(
    WJobs jobs, int B, int N, int rows_per_split, long long part_stride) {
  wgrad_tile(jobs, B, N, rows_per_split, part_stride);
}

#endif  // !TK_BF16

BiRows make_rows(const void* active, const void* hl_f, const void* hl_b,
                 const void* imp, const void* sel_x) {
  BiRows q;
  q.active = static_cast<const float*>(active);
  q.hl_f = static_cast<const float*>(hl_f);
  q.hl_b = static_cast<const float*>(hl_b);
  q.imp = static_cast<const float*>(imp);
  q.sel_x = static_cast<const float*>(sel_x);
  return q;
}

}  // namespace

#if !TK_BF16
extern "C" int bi_layer_launch(
    const void* x, const void* rowptr, const void* src, const void* rel,
    const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, int relu, const void* wih_f,
    const void* whh_f, const void* bih_f, const void* bhh_f,
    const void* wih_b, const void* whh_b, const void* bih_b,
    const void* bhh_b, const void* dt_f, const void* dt_b, float lam,
    const void* prev_f, const void* prev_b, const void* active,
    const void* hl_f, const void* hl_b, const void* imp, const void* sel_x,
    void* out, void* gin_out, int B, int N, int d, void* stream) {
  if (B > 0 && N > 0) {
    const Layer pf = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                                wcol, loopw, mask, relu, wih_f, whh_f, bih_f,
                                bhh_f, nullptr, nullptr, dt_f, lam, prev_f, 1,
                                N, d, 0);
    const Layer pb = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                                wcol, loopw, mask, relu, wih_b, whh_b, bih_b,
                                bhh_b, nullptr, nullptr, dt_b, lam, prev_b, 1,
                                N, d, 0);
    // 32-row tiles of d / 16 warps over the B * N rows (1,784 blocks at the
    // main shape, two an SM), as K9+K10's GRU tile
    return static_cast<int>(launch_bwd_tile(
        bi_layer_kernel, bi_tile_smem_floats(d), B, N, d, stream, pf, pb,
        make_rows(active, hl_f, hl_b, imp, sel_x), static_cast<float*>(out),
        static_cast<float*>(gin_out)));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bi_bwd_gru_launch(
    const void* x, const void* rowptr, const void* src, const void* rel,
    const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, int relu, const void* wih_f_t,
    const void* whh_f_t, const void* bih_f, const void* bhh_f,
    const void* wih_b_t, const void* whh_b_t, const void* bih_b,
    const void* bhh_b, const void* wih_f, const void* whh_f,
    const void* wih_b, const void* whh_b, const void* dt_f,
    const void* dt_b, float lam, const void* prev_f, const void* prev_b,
    const void* active, const void* hl_f, const void* hl_b, const void* imp,
    const void* dout, void* dprev_f, void* dprev_b, void* dhl_f, void* dhl_b,
    void* dimp_rows, void* n2_out, void* gin_s, void* h0f_s, void* h0b_s,
    void* dgi_f, void* dgh_f, void* dgi_b, void* dgh_b, void* dconv_s,
    void* dlp_s, void* relu_out, int B, int N, int d, void* stream) {
  if (B > 0 && N > 0) {
    const Layer pf = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                                wcol, loopw, mask, relu, wih_f_t, whh_f_t,
                                bih_f, bhh_f, nullptr, nullptr, dt_f, lam,
                                prev_f, 1, N, d, 0);
    const Layer pb = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                                wcol, loopw, mask, relu, wih_b_t, whh_b_t,
                                bih_b, bhh_b, nullptr, nullptr, dt_b, lam,
                                prev_b, 1, N, d, 0);
    // 32-row tiles of d / 16 warps over the B * N rows (1,784 blocks at the
    // main shape, two an SM), as K5's GRU tile
    return static_cast<int>(launch_bwd_tile(
        bi_bwd_gru_kernel, bi_tile_smem_floats(d), B, N, d, stream, pf, pb,
        make_rows(active, hl_f, hl_b, imp, nullptr),
        static_cast<const float*>(wih_f), static_cast<const float*>(whh_f),
        static_cast<const float*>(wih_b), static_cast<const float*>(whh_b),
        static_cast<const float*>(dout), static_cast<float*>(dprev_f),
        static_cast<float*>(dprev_b), static_cast<float*>(dhl_f),
        static_cast<float*>(dhl_b), static_cast<float*>(dimp_rows),
        static_cast<float*>(n2_out), static_cast<float*>(gin_s),
        static_cast<float*>(h0f_s), static_cast<float*>(h0b_s),
        static_cast<float*>(dgi_f), static_cast<float*>(dgh_f),
        static_cast<float*>(dgi_b), static_cast<float*>(dgh_b),
        static_cast<float*>(dconv_s), static_cast<float*>(dlp_s),
        static_cast<float*>(relu_out)));
  }
  return static_cast<int>(cudaGetLastError());
}

// The weight jobs of one bidirectional layer over its B*N rows: (gin, d_gi_f)
// -> dwih_f + dbih_f, (h0g_f, d_gh_f) -> dwhh_f + dbhh_f, the same for the
// backward GRU, (x, d_lp) -> dloop, and with impute (dimp_rows not null) the
// column sums of the rows' four impute terms -> dimp. `part` holds n_split
// copies of the flat outputs, each laid out dwih_f [d, 3d], dbih_f [3d],
// dwhh_f [d, 3d], dbhh_f [3d], the same four for the backward GRU, dloop
// [d, d], dimp [4]; it must start at zero.
extern "C" int bi_wgrad_launch(const void* gin_s, const void* h0f_s,
                               const void* h0b_s, const void* dgi_f,
                               const void* dgh_f, const void* dgi_b,
                               const void* dgh_b, const void* x,
                               const void* dlp_s, const void* dimp_rows,
                               void* part, int n_split, int B, int N, int d,
                               void* stream) {
  if (B > 0 && N > 0 && n_split > 0) {
    const long long sd = (long long)N * d, sg = 3LL * N * d;
    const long long dd = (long long)d * d;
    float* wih_f = static_cast<float*>(part);
    float* bih_f = wih_f + 3 * dd;
    float* whh_f = bih_f + 3 * d;
    float* bhh_f = whh_f + 3 * dd;
    float* wih_b = bhh_f + 3 * d;
    float* bih_b = wih_b + 3 * dd;
    float* whh_b = bih_b + 3 * d;
    float* bhh_b = whh_b + 3 * dd;
    float* loop = bhh_b + 3 * d;
    float* imp = loop + dd;
    const long long total = (imp + 4) - wih_f;
    int first = 0;
    WJobs jobs = {};
    jobs.job[0] = make_job(gin_s, sd, dgi_f, sg, wih_f, bih_f, d, 3 * d,
                           &first);
    jobs.job[1] = make_job(h0f_s, sd, dgh_f, sg, whh_f, bhh_f, d, 3 * d,
                           &first);
    jobs.job[2] = make_job(gin_s, sd, dgi_b, sg, wih_b, bih_b, d, 3 * d,
                           &first);
    jobs.job[3] = make_job(h0b_s, sd, dgh_b, sg, whh_b, bhh_b, d, 3 * d,
                           &first);
    jobs.job[4] = make_job(x, sd, dlp_s, sd, loop, nullptr, d, d, &first);
    if (dimp_rows != nullptr)
      jobs.job[5] = make_job(nullptr, 0, dimp_rows, 4LL * N, imp, imp, 0, 4,
                             &first);
    else
      jobs.job[5].first = kNoJob;
    return static_cast<int>(launch_wgrad(bi_wgrad_kernel, jobs, first,
                                         n_split, B, N, total, stream));
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // !TK_BF16
