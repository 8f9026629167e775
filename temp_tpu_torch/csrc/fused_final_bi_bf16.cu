// K6+K7 and K9+K10 in their bfloat16 mode. Replaces the bfloat16
// instantiation of temp_tpu/ops/fused_final_bi.py: _conv_fwd_bi_kernel,
// _gru_fwd_bi_kernel, _gru_bwd_bi_kernel and _conv_bwd_bi_kernel (K8 and
// K4: fused_final_bf16.cu's launches).
//
// Both are their own kernels on the native bfloat16 routines of
// window_bf16.cuh (mma.sync m16n8k16 bf16, fragments by ldmatrix, operands
// staged once as bfloat16 by cp.async; its note says what they compute),
// with the launches and arguments of fused_final_bi.cu's (its note
// describes them), exported as bi_layer_launch_bf16, bi_bwd_gru_launch_bf16
// and bi_wgrad_launch_bf16; K9+K10's input launch is K5's
// (final_bwd_input_launch_bf16). The operands: the layer's input x (the
// embeddings, or layer 1's output) bfloat16, rounded once by the wrapper;
// loopw, both GRUs' wih_t, whh_t (and K9+K10's wih, whh and loop_t) the
// wrapper's bfloat16 copies; the histories and local tables bfloat16;
// K9+K10's gin_s, h0f_s and h0b_s bfloat16 scratch (the weight launch reads
// them only rounded); the rest float32, the layer's output and the GRU
// input K6+K7 may write (gin_out) too.
//
// K6+K7 (bi_layer_kernel) and K9+K10's GRU tile (bi_bwd_gru_kernel) form
// the conv output (conv_tc_bf: K2b's routine), the GRU input at the
// thread's own positions from the float32 conv output (gin_at: the impute
// blend in float32, then rounded once into shared memory) and each
// direction's gates (gate_products_bf) with the same routines, whose sums
// do not depend on the tile's rows or the ring's slot depth: so the GRU
// input the forward forms, rounded, equals bit for bit the one the
// backward recomputes into gin_s, and the ReLU takes the same branch in
// both. What the TPU kernels read unrounded stays float32: the conv output
// (kept in registers; parked in dconv_s for the backward's impute terms),
// the decayed states of the GRUs' blends (prev_f32), the gate cotangents
// of the bias sums, the impute terms and their row sums (the float32
// build's order).
//
// K6+K7's tile: kBiFwdRows = 32 rows (two m16 tiles, 256 threads of d / 16
// warps, all d columns; 1,784 blocks at the main shape, B = 8, N = 7,128,
// d = 128), so each block streams the weights through its ring for twice
// K9+K10's rows. Its shared memory is a ring (three gate windows of all d
// columns in slots of kGruKs rows, which the conv's one window fits), the
// GRU input rows (bfloat16) and a region that holds the input rows with
// the float32 SpMM rows for the conv, then each direction's decayed states
// in turn; 110,592 bytes at d = 128, two blocks an SM at
// __launch_bounds__(256, 2). The forward direction's GRU output waits in
// registers (16 floats a thread) under the backward direction's products.
// K9+K10's 16-row tile (slots of kBfKs rows, 55,296 bytes) took 0.927 ms of
// device time a step for both layers at three blocks an SM and 0.902-0.937
// at four, where this one took 0.678 on an H100.
//
// K9+K10: a 16-row tile (one m16 tile, 256 threads of d / 16 warps; 3,568
// blocks at the main shape) holds its state in half the registers of
// float32's 32-row tile, and its shared memory is a ring and a 16-row
// region reused in turn: the input rows and the float32 SpMM rows for the
// conv, then a direction's decayed states, then its gate cotangents (4d
// wide, bfloat16); only the GRU input (bfloat16) lives beside it across
// both directions. 72,192 bytes at d = 128, so three blocks an SM
// (float32's two blocks of 32 rows took 105,216), at
// __launch_bounds__(256, 3): 80 registers a thread, whatever the compiler
// cannot keep in them spilled to local memory (292 bytes of stores a
// thread; at __launch_bounds__(256, 2), two blocks an SM and up to 128
// registers, the tile took 6% longer on an H100, tools/window_ab.py
// --bf16). The second direction's states are copied after the first
// direction's last product, not under it. Each direction runs its gates
// (gate_products_bf) and gate cotangents' products
// (gate_cotangent_products_bf) as K2b's GRU tile does, the ten products on
// tile_product_bf. The weight launch: K2b's bfloat16 tiles with float32's
// six jobs (both GRUs', the self-loop's, the impute scalars' column sums;
// 53 tiles by 16 ranges). No atomics; the sums across rows go to per-range
// copies reduced in a fixed order by the float32 build's reduction, so runs
// repeat bit for bit.
#define TK_BF16 1
#include "fused_final_bi.cu"
#include "window_bf16.cuh"

namespace {

// K6+K7's tile: rows, the ring's slot depth for the gate products, and the
// blocks an SM it is built for.
constexpr int kBiFwdRows = 32;
constexpr int kBiFwdKs = kGruKs;
constexpr int kBiFwdBlocks = 2;

// Shared memory of bi_layer_kernel in bytes: the ring (three gate windows
// of all d columns in slots of kBiFwdKs rows, or the conv's one window in
// slots of kGruKs); the GRU input rows cs (bfloat16); the region (the input
// rows and the float32 SpMM rows, then a direction's decayed states); the
// two directions' RowInfo. 110,592 bytes at d = 128.
__host__ __device__ constexpr int bi_fwd_bf_ring_bytes(int d) {
  return bf_ring_bytes(3, d, kBiFwdKs) > bf_ring_bytes(1, d, kGruKs)
             ? bf_ring_bytes(3, d, kBiFwdKs)
             : bf_ring_bytes(1, d, kGruKs);
}

__host__ __device__ constexpr int bi_fwd_bf_region_bytes(int d) {
  return bf_rows_bytes(kBiFwdRows, d) + f32_rows_bytes(kBiFwdRows, d);
}

__host__ __device__ constexpr int bi_fwd_bf_smem_bytes(int d) {
  return bi_fwd_bf_ring_bytes(d) + bf_rows_bytes(kBiFwdRows, d) +
         bi_fwd_bf_region_bytes(d) + 2 * kBiFwdRows * 16;
}

// One direction's GRU forward for the tile (p its Layer, ri its rows'
// RowInfo): its decayed states copied into hs (the region, free at the
// call), its gates from the GRU input cs and hs (gate_products_bf), then
// at the thread's own positions its output (1 - z) n + z h into h, added
// to what is there when `add` (the second direction). Ends with the gate
// products' barrier.
template <int MT>
__device__ __forceinline__ void bi_direction_fwd_bf(
    const Layer& p, const RowInfo* ri, const bf16* cs, bf16* hs, bf16* ring,
    int a0, float (&h)[MT][2][4], bool add) {
  constexpr int R = MT * 16;
  const int d = p.d, ld = d + kBfPad, c0 = warp_col0();
  copy_prev_bf(p, a0, R, ld, ri, hs);
  float acc[4][MT][2][4];
  gate_products_bf<MT, kBiFwdKs>(p, cs, hs, ld, ri, R, 0, d, ring, acc);
  const GateBias gb = gate_bias(p.bih, p.bhh, d, c0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i);
        const GateAt g = gate_at_bf<MT>(acc, mt, nt, i, gb);
        const float v = (1.f - g.z) * g.n + g.z * prev_f32(p, ri, r, c);
        h[mt][nt][i] = add ? h[mt][nt][i] + v : v;
      }
}

// One bidirectional layer forward for a tile of kBiFwdRows rows
// (blockIdx.x) of element blockIdx.y, with d / 16 warps (the float32
// bi_layer_kernel's outputs, natively): the input rows, the SpMM rows and
// the conv output (conv_tc_bf, the ReLU when pf.relu), the GRU input at
// the thread's own positions (gin_at on the float32 conv output, rounded
// once into cs; the next product's opening barrier publishes it), then
// each direction (bi_direction_fwd_bf). Writes the sum of the two GRUs, or
// on an inactive row sel_x's when it is not null; with gin_out also the
// float32 GRU input, for holding it to K9+K10's recompute.
__global__ void __launch_bounds__(256, kBiFwdBlocks) bi_layer_kernel(
    Layer pf, Layer pb, BiRows q, float* __restrict__ out,
    float* __restrict__ gin_out) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int MT = kBiFwdRows / 16, R = kBiFwdRows;
  const int d = pf.d, N = pf.A, ld = d + kBfPad, ldf = d + 4;
  bf16* ring = reinterpret_cast<bf16*>(smem_b);
  bf16* cs = ring + bi_fwd_bf_ring_bytes(d) / 2;   // the GRU input, rounded
  bf16* xs = cs + R * ld;                           // the region
  float* S = reinterpret_cast<float*>(xs + R * ld);
  RowInfo* ri_f = reinterpret_cast<RowInfo*>(
      reinterpret_cast<unsigned char*>(xs) + bi_fwd_bf_region_bytes(d));
  RowInfo* ri_b = ri_f + R;
  const int b = blockIdx.y, a0 = blockIdx.x * R, c0 = warp_col0();

  row_info(pf, b, a0, R, ri_f);
  row_info(pb, b, a0, R, ri_b);
  copy_x_bf(pf, b, a0, R, ld, xs);
  __syncthreads();                      // ri
  spmm_rows(pf, b, a0, R, S, ldf, nullptr);
  float cv[MT][2][4];
  conv_tc_bf<MT, kGruKs>(pf, b, a0, xs, cs, S, ld, ldf, ring, d, 0, cv);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        if (a >= N) continue;
        const long long row = (long long)b * N + a;
        const long long e = row * d + c;
        const float gv = gin_at(pf, pb, q, row, e, cv[mt][nt][i]);
        cs[r * ld + c] = __float2bfloat16_rn(gv);
        if (gin_out != nullptr) gin_out[e] = gv;
      }

  // the input rows xs are free since the conv's last barrier: the states
  // go there
  float h[MT][2][4];
  bi_direction_fwd_bf<MT>(pf, ri_f, cs, xs, ring, a0, h, false);
  bi_direction_fwd_bf<MT>(pb, ri_b, cs, xs, ring, a0, h, true);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + acc_col(nt, i), a = a0 + acc_row(mt, i);
        if (a >= N) continue;
        const long long row = (long long)b * N + a;
        out[row * d + c] = q.sel_x != nullptr && !(q.active[row] > 0.f)
                               ? q.sel_x[row * d + c] : h[mt][nt][i];
      }
}

Shape bi_fwd_shape(int B, int N, int d) {
  return tile_shape(B, N, d, kBiFwdRows, bi_fwd_bf_smem_bytes(d));
}

// Shared memory of bi_bwd_gru_kernel in bytes: the ring (K2b's GRU tile's);
// the GRU input rows cs (bfloat16); the region, whose largest tenant is a
// direction's gate cotangents dg ([16, 4d + 8] bfloat16; before it the
// input rows and the float32 SpMM rows, then the decayed states); the two
// directions' RowInfo. 72,192 bytes at d = 128.
__host__ __device__ constexpr int bi_bwd_bf_region_bytes(int d) {
  return bf_rows_bytes(kBfBwdRows, d) + f32_rows_bytes(kBfBwdRows, d) >
                 kBfBwdRows * (4 * d + kBfPad) * 2
             ? bf_rows_bytes(kBfBwdRows, d) + f32_rows_bytes(kBfBwdRows, d)
             : kBfBwdRows * (4 * d + kBfPad) * 2;
}

__host__ __device__ constexpr int bi_bwd_bf_smem_bytes(int d) {
  return bwd_gru_bf_ring_bytes(d) + bf_rows_bytes(kBfBwdRows, d) +
         bi_bwd_bf_region_bytes(d) + 2 * kBfBwdRows * 16;
}

// One direction's GRU backward for the tile (p its Layer, ri its rows'
// RowInfo): its decayed states copied into hs (the region), its gates from
// the GRU input cs and hs (gate_products_bf), the gate cotangents float32
// into the step scratch (with h0g, rounded), d_gi @ W_ih and d_gh @ W_hh
// (gate_cotangent_products_bf, dg over the region), then at the thread's
// own positions the previous state's cotangent (d_out * z + d_gh @ W_hh,
// decayed) into dprev and d_gi @ W_ih into dgin, added to what is there
// when `add` (the second direction). Starts after a barrier that frees the
// region; ends with one.
__device__ __forceinline__ void bi_direction_bwd_bf(
    const Layer& p, const RowInfo* ri, const bf16* __restrict__ wih,
    const bf16* __restrict__ whh, const bf16* cs, bf16* hs, bf16* ring,
    int b, int a0, const float* __restrict__ dout,
    bf16* __restrict__ h0g_s, float* __restrict__ dgi_s,
    float* __restrict__ dgh_s, float* __restrict__ dprev, float* dgin,
    bool add) {
  constexpr int MT = kBfBwdRows / 16, R = kBfBwdRows;
  const int d = p.d, N = p.A, d3 = 3 * d;
  const int ld = d + kBfPad, ldg = 4 * d + kBfPad, c0 = warp_col0();
  copy_prev_bf(p, a0, R, ld, ri, hs);
  float acc[4][MT][2][4];
  gate_products_bf<MT, kBfKs>(p, cs, hs, ld, ri, R, 0, d, ring, acc);
  const GateBias gb = gate_bias(p.bih, p.bhh, d, c0);
  float dh_direct[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        float pr = 0.f, pz = 0.f, pn = 0.f, phn = 0.f, dhd = 0.f;
        if (a < N) {
          const long long m = (long long)b * N + a;
          const GateAt g = gate_at_bf<MT>(acc, mt, nt, i, gb);
          const float dv = dout[m * d + c];
          const float h = prev_f32(p, ri, r, c);
          const float dz = dv * (h - g.n);
          const float dn = dv * (1.f - g.z);
          dhd = dv * g.z;
          pn = dn * (1.f - g.n * g.n);
          phn = pn * g.r;
          pr = pn * g.ghn * g.r * (1.f - g.r);
          pz = dz * g.z * (1.f - g.z);
          h0g_s[m * d + c] = __float2bfloat16_rn(h);
          dgi_s[m * d3 + c] = pr;
          dgi_s[m * d3 + d + c] = pz;
          dgi_s[m * d3 + 2 * d + c] = pn;
          dgh_s[m * d3 + c] = pr;
          dgh_s[m * d3 + d + c] = pz;
          dgh_s[m * d3 + 2 * d + c] = phn;
        }
        dh_direct[mt][nt][i] = dhd;
        acc[0][mt][nt][i] = pr;
        acc[1][mt][nt][i] = pz;
        acc[2][mt][nt][i] = pn;
        acc[3][mt][nt][i] = phn;
      }
  float dx[2][MT][2][4] = {};
  gate_cotangent_products_bf<MT>(acc, wih, whh, d, hs, ldg, ring, dx);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        if (a >= N) continue;
        const long long e = ((long long)b * N + a) * d + c;
        dprev[e] = (dh_direct[mt][nt][i] + dx[1][mt][nt][i]) * ri[r].dec;
        dgin[e] = add ? dgin[e] + dx[0][mt][nt][i] : dx[0][mt][nt][i];
      }
}

// Backward of one bidirectional layer's row part for a tile of kBfBwdRows
// rows (blockIdx.x) of element blockIdx.y, with d / 16 warps (the float32
// bi_bwd_gru_kernel's outputs, natively): the conv output recomputed
// (conv_tc_bf), the GRU input from it (gin_at), then each direction in
// turn (bi_direction_bwd_bf; d_gin waits in dlp_s, which takes its own
// value last, at the thread's own positions), then the input's cotangent
// through the blend and the ReLU and the impute terms. The conv output
// before the blend waits in dconv_s for the impute terms (written and read
// by the same thread), the ReLU's signs in a register. With relu_out it
// also writes the ReLU's pattern (1 where it passes).
__global__ void __launch_bounds__(256, 3) bi_bwd_gru_kernel(
    Layer pf, Layer pb, BiRows q, const bf16* __restrict__ wih_f,
    const bf16* __restrict__ whh_f, const bf16* __restrict__ wih_b,
    const bf16* __restrict__ whh_b, const float* __restrict__ dout,
    float* __restrict__ dprev_f, float* __restrict__ dprev_b,
    float* __restrict__ dhl_f, float* __restrict__ dhl_b,
    float* __restrict__ dimp_rows, float* __restrict__ n2_out,
    bf16* __restrict__ gin_s, bf16* __restrict__ h0f_s,
    bf16* __restrict__ h0b_s, float* __restrict__ dgi_f,
    float* __restrict__ dgh_f, float* __restrict__ dgi_b,
    float* __restrict__ dgh_b, float* __restrict__ dconv_s,
    float* __restrict__ dlp_s, float* __restrict__ relu_out) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int MT = kBfBwdRows / 16, R = kBfBwdRows;
  const int d = pf.d, N = pf.A, ld = d + kBfPad, ldf = d + 4;
  bf16* ring = reinterpret_cast<bf16*>(smem_b);
  bf16* cs = ring + bwd_gru_bf_ring_bytes(d) / 2;  // the GRU input, rounded
  bf16* xs = cs + R * ld;                          // the region
  float* S = reinterpret_cast<float*>(xs + R * ld);
  RowInfo* ri_f = reinterpret_cast<RowInfo*>(
      reinterpret_cast<unsigned char*>(xs) + bi_bwd_bf_region_bytes(d));
  RowInfo* ri_b = ri_f + R;
  const int b = blockIdx.y, a0 = blockIdx.x * R, c0 = warp_col0();
  const bool impute = q.hl_f != nullptr;

  row_info(pf, b, a0, R, ri_f);
  row_info(pb, b, a0, R, ri_b);
  copy_x_bf(pf, b, a0, R, ld, xs);
  __syncthreads();                      // ri
  spmm_rows(pf, b, a0, R, S, ldf, n2_out);
  float cv[MT][2][4];
  conv_tc_bf<MT, kGruKs>(pf, b, a0, xs, cs, S, ld, ldf, ring, d, 0, cv);
  // the GRU input, at the thread's own positions of cs
  unsigned pos_bits = 0;                // conv output > 0, by position
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        const float v = cv[mt][nt][i];
        if (v > 0.f) pos_bits |= 1u << ((mt * 2 + nt) * 4 + i);
        if (a >= N) continue;
        const long long row = (long long)b * N + a;
        const long long e = row * d + c;
        if (relu_out != nullptr)
          relu_out[e] = !pf.relu || v > 0.f ? 1.f : 0.f;
        if (impute) dconv_s[e] = v;
        const bf16 gv = __float2bfloat16_rn(gin_at(pf, pb, q, row, e, v));
        cs[r * ld + c] = gv;
        gin_s[e] = gv;
      }
  __syncthreads();                      // S read: the region is free

  bi_direction_bwd_bf(pf, ri_f, wih_f, whh_f, cs, xs, ring, b, a0, dout,
                      h0f_s, dgi_f, dgh_f, dprev_f, dlp_s, false);
  bi_direction_bwd_bf(pb, ri_b, wih_b, whh_b, cs, xs, ring, b, a0, dout,
                      h0b_s, dgi_b, dgh_b, dprev_b, dlp_s, true);

  // the input's cotangent through the blend and the ReLU; the impute
  // terms' rows, float32, into the ring (free since the last product's
  // barrier)
  float* tf = reinterpret_cast<float*>(ring);
  float* tb = tf + R * ldf;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
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
              const float cvv = dconv_s[e];
              hlf = wf * dxv;
              hlb = wb * dxv;
              pfv = dxv * (local_at(q.hl_f, e) - cvv);
              pbv = dxv * (local_at(q.hl_b, e) - cvv);
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
        tf[r * ldf + c] = pfv;
        tb[r * ldf + c] = pbv;
      }
  if (!impute) return;
  __syncthreads();

  // each row's impute terms, summed as the float32 build does: d w_dir /
  // d a_dir = -w_dir where a_dir > 0
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int r = warp; r < R; r += nwarps) {
    float sf = 0.f, sb = 0.f;
    for (int c = lane; c < d; c += kWarp) {
      sf += tf[r * ldf + c];
      sb += tb[r * ldf + c];
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
    WJobsBf jobs, int B, int N, int rows_per_split, long long part_stride) {
  wgrad_tile_bf(jobs, B, N, rows_per_split, part_stride);
}

Shape bi_gru_shape(int B, int N, int d) {
  return tile_shape(B, N, d, kBfBwdRows, bi_bwd_bf_smem_bytes(d));
}

}  // namespace

// x, loopw, the four GRU weights, the histories and the local tables
// bfloat16; sel_x, out and gin_out float32.
extern "C" int bi_layer_launch_bf16(
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
                                N, d, 0, 1);
    const Layer pb = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                                wcol, loopw, mask, relu, wih_b, whh_b, bih_b,
                                bhh_b, nullptr, nullptr, dt_b, lam, prev_b, 1,
                                N, d, 0, 1);
    const Shape s = bi_fwd_shape(B, N, d);
    cudaError_t err = allow_smem(bi_layer_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    bi_layer_kernel<<<s.grid, s.threads, s.bytes,
                      static_cast<cudaStream_t>(stream)>>>(
        pf, pb, make_rows(active, hl_f, hl_b, imp, sel_x),
        static_cast<float*>(out), static_cast<float*>(gin_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// x, loopw, the four GRU weights in both layouts, the histories and the
// local tables bfloat16; gin_s, h0f_s and h0b_s bfloat16 scratch.
extern "C" int bi_bwd_gru_launch_bf16(
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
                                prev_f, 1, N, d, 0, 1);
    const Layer pb = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                                wcol, loopw, mask, relu, wih_b_t, whh_b_t,
                                bih_b, bhh_b, nullptr, nullptr, dt_b, lam,
                                prev_b, 1, N, d, 0, 1);
    const Shape s = bi_gru_shape(B, N, d);
    cudaError_t err = allow_smem(bi_bwd_gru_kernel, s.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    bi_bwd_gru_kernel<<<s.grid, s.threads, s.bytes,
                        static_cast<cudaStream_t>(stream)>>>(
        pf, pb, make_rows(active, hl_f, hl_b, imp, nullptr),
        static_cast<const bf16*>(wih_f), static_cast<const bf16*>(whh_f),
        static_cast<const bf16*>(wih_b), static_cast<const bf16*>(whh_b),
        static_cast<const float*>(dout), static_cast<float*>(dprev_f),
        static_cast<float*>(dprev_b), static_cast<float*>(dhl_f),
        static_cast<float*>(dhl_b), static_cast<float*>(dimp_rows),
        static_cast<float*>(n2_out), static_cast<bf16*>(gin_s),
        static_cast<bf16*>(h0f_s), static_cast<bf16*>(h0b_s),
        static_cast<float*>(dgi_f), static_cast<float*>(dgh_f),
        static_cast<float*>(dgi_b), static_cast<float*>(dgh_b),
        static_cast<float*>(dconv_s), static_cast<float*>(dlp_s),
        static_cast<float*>(relu_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// fused_final_bi.cu's weight jobs, their X operands (gin_s, h0f_s, h0b_s,
// x) bfloat16, their G operands float32; the impute scalars' job has no X
// (its G, dimp_rows, stands in as the pointer that is never read); `part`
// the same float32 copies in the same layout.
extern "C" int bi_wgrad_launch_bf16(const void* gin_s, const void* h0f_s,
                                    const void* h0b_s, const void* dgi_f,
                                    const void* dgh_f, const void* dgi_b,
                                    const void* dgh_b, const void* x,
                                    const void* dlp_s, const void* dimp_rows,
                                    void* part, int n_split, int B, int N,
                                    int d, void* stream) {
  if (B > 0 && N > 0 && n_split > 0) {
    const long long sd = (long long)N * d, sg = 3LL * N * d;
    const long long dd = (long long)d * d;
    const bf16* gin = static_cast<const bf16*>(gin_s);
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
    WJobsBf jobs = {};
    jobs.job[0] = make_job_bf(gin, sd, dgi_f, sg, wih_f, bih_f, d, 3 * d,
                              &first);
    jobs.job[1] = make_job_bf(static_cast<const bf16*>(h0f_s), sd, dgh_f, sg,
                              whh_f, bhh_f, d, 3 * d, &first);
    jobs.job[2] = make_job_bf(gin, sd, dgi_b, sg, wih_b, bih_b, d, 3 * d,
                              &first);
    jobs.job[3] = make_job_bf(static_cast<const bf16*>(h0b_s), sd, dgh_b, sg,
                              whh_b, bhh_b, d, 3 * d, &first);
    jobs.job[4] = make_job_bf(static_cast<const bf16*>(x), sd, dlp_s, sd,
                              loop, nullptr, d, d, &first);
    if (dimp_rows != nullptr)
      jobs.job[5] = make_job_bf(static_cast<const bf16*>(dimp_rows), 0,
                                dimp_rows, 4LL * N, imp, imp, 0, 4, &first);
    else
      jobs.job[5].first = kNoJob;
    cudaError_t err = allow_smem(bi_wgrad_kernel, kWgSmemBytesBf);
    if (err != cudaSuccess) return static_cast<int>(err);
    bi_wgrad_kernel<<<dim3(first, n_split), kWgThreads, kWgSmemBytesBf,
                      static_cast<cudaStream_t>(stream)>>>(
        jobs, B, N, wgrad_rows_per_split(B * N, n_split), total);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape and occupancy of K9+K10's bfloat16 kernel `which` (0
// its GRU tile, 1 its weight launch) or of K6+K7's bfloat16 launch (2) at
// width d: out[0] its shared memory a block in bytes, out[1] its threads,
// out[2] the blocks an SM holds, out[3] its registers a thread, out[4] its
// local memory a thread in bytes.
extern "C" int bi_bf16_occupancy(int which, int d, void* out) {
  int* o = static_cast<int*>(out);
  switch (which) {
    case 0: {
      const Shape s = bi_gru_shape(1, 1, d);
      return static_cast<int>(
          occupancy(bi_bwd_gru_kernel, s.threads, s.bytes, o, 5));
    }
    case 1:
      return static_cast<int>(occupancy(bi_wgrad_kernel, kWgThreads,
                                        kWgSmemBytesBf, o, 5));
    case 2: {
      const Shape s = bi_fwd_shape(1, 1, d);
      return static_cast<int>(
          occupancy(bi_layer_kernel, s.threads, s.bytes, o, 5));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
