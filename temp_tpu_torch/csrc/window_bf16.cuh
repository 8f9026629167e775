// The native bfloat16 products of the tensor cores: the device routines of
// the history window's bfloat16 mode (K2f and K2b, fused_window_bf16.cu)
// and of the final step's bfloat16 layers (K3's layer launches and K5,
// fused_final_bf16.cu, on K2f's and K2b's tiles at one step; K6+K7 and
// K9+K10, fused_final_bi_bf16.cu, on K2b's routines), each source
// including this header after rgcn_gru_layer.cuh with TK_BF16 1.
//
// What they compute is the TPU kernels' bfloat16 instantiation
// (temp_tpu/ops/fused_window.py _fwd_kernel, _bwd_kernel, fused_final.py
// _fwd_kernel's encoder, _bwd_layer_kernel, fused_final_bi.py
// _conv_fwd_bi_kernel, _gru_fwd_bi_kernel, _gru_bwd_bi_kernel,
// _conv_bwd_bi_kernel with dtype_str "bfloat16"): every product
// _dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32). A product of two bfloat16 values is exact in
// float32, so mma.sync m16n8k16 with bfloat16 operands and float32
// accumulators computes that function itself, 16 depth terms a step: no
// operand is rounded inside a product loop. Each operand is rounded once:
// the weights by the wrapper (bfloat16 copies, JAX's w.astype(bf16)), the
// layer's input by the wrapper or already bfloat16 (the window's layer 1
// rows and the final step's layer inputs by the wrapper, layer 1's buffer
// as the window's layer 2 input), and each row operand (the conv output or
// the GRU input, the decayed previous states, the gate cotangents, d_lp)
// when its tile stages it in shared memory. Where the TPU kernel reads a value unrounded,
// so do these routines, at the thread's own accumulator positions: the
// GRU blend z * h and the backward's d_z read the float32 decayed state
// (the bfloat16 state times live * decay, recomputed), the local output and
// the ReLU the float32 conv output (kept in registers), the bias cotangents
// the float32 gate cotangents (the weight launch rounds its own staged copy
// of them). The SpMM is rgcn_gru_layer.cuh's bfloat16 mode (spmm_rows); its
// transpose, bwd_input_tile_bf's, rounds where the TPU kernel's one-hot
// products do.
//
// What bounds them on an H100: not the operations (the main shape's K2f
// launch is 0.31 GFLOP, a fraction of a microsecond at the bfloat16 rate)
// but the chain of dependent steps a block walks through (copies, barriers,
// the products' k steps) and how many blocks an SM holds to hide it. So the
// design: operands staged once as bfloat16 by 16-byte cp.async (half the
// bytes of float32 staging, no widening loads), fragments loaded by
// ldmatrix from rows padded to (n + 8) bfloat16 values (no bank
// conflicts), one k16 step a ring slot (half the barrier-separated steps of
// the k8 TF32 design), and less shared memory a block (more blocks an SM).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBfKs = 16;    // depth rows a ring slot of K2b's tiles
constexpr int kFwdKs = 32;   // and of K2f's: two k16 steps a barrier
constexpr int kGruKs = 32;   // of K2b's GRU tile's self-loop and transposed
                             // gate products (its gate products kBfKs)
constexpr int kInKs = 32;    // of K2b's input tile
constexpr int kBfPad = 8;    // bfloat16 values of padding a staged row
constexpr int kBfBwdRows = 16;  // rows of K2b's GRU tile: one m16 tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid
// (then nothing is read at src).
__device__ __forceinline__ void cp_async16_b(void* dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Two floats rounded to bfloat16 (to nearest even) as one 32-bit word,
// the first in the low half; and back.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// Four 8 x 8 bfloat16 matrices from shared memory, lane l naming row l % 8
// of matrix l / 8; .trans hands each lane the transposed elements.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A B over one k16 step: bfloat16 operands, exact products, float32
// sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's row address for ldsm_x4 of a 16 x 16 block at (row 0, col 0)
// of p (row stride ld): rows 0-15 by lane % 16, columns 0-7 or 8-15 by
// lane / 16. So the four registers are (rows 0-7, cols 0-7), (rows 8-15,
// cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15): A's m16 x k16
// fragment of a row-major array, or with ldsm_x4_t two n8 fragments of B
// (registers 0-1 columns 0-7, 2-3 columns 8-15) of a depth-major one.
__device__ __forceinline__ const bf16* frag_ptr(const bf16* p, int ld) {
  const int lane = threadIdx.x % kWarp;
  return p + (lane & 15) * ld + (lane >> 4) * 8;
}

// The same for A's fragment from a depth-major [k, m] array with
// ldsm_x4_t: depth rows 0-7 or 8-15 by lane / 16, m columns 0-7 or 8-15 by
// (lane / 8) % 2.
__device__ __forceinline__ const bf16* frag_ptr_t(const bf16* p, int ld) {
  const int lane = threadIdx.x % kWarp;
  return p + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// Bytes of a ring of kRingSlots slots of ks depth rows of G windows of
// wcols columns, of `rows` staged bfloat16 rows of d values, and of `rows`
// float32 rows of d values (row stride d + 4).
__host__ __device__ constexpr int bf_ring_bytes(int G, int wcols, int ks) {
  return kRingSlots * ks * (G * wcols + kBfPad) * 2;
}

__host__ __device__ constexpr int bf_rows_bytes(int rows, int d) {
  return rows * (d + kBfPad) * 2;
}

__host__ __device__ constexpr int f32_rows_bytes(int rows, int d) {
  return rows * (d + 4) * 4;
}

// The block's product routine in bfloat16: acc[Slot_g] += A @ W_g for g <
// G, over the warp's 16 columns of each W_g. A: MT * 16 rows in shared
// memory (bfloat16, row-major, row stride lda, depth column 0 at a); W_g:
// [K, *] bfloat16 windows in device memory (row stride ldw, column 0 at
// w[g]) of wcols columns. The K depth rows of the G windows stream through
// `ring` in slots of KS rows (cp.async, kRingSlots slots in flight, one
// barrier a slot, KS / 16 k16 steps), each weight element read from device
// memory once a block. Warp w owns columns 16w..16w+15 of every window and
// all the block's rows: a k16 step is MT ldmatrix of A, one ldmatrix.trans
// of each window and 2 MT G mma.sync m16n8k16. K and wcols are multiples
// of 16.
// Starts with a barrier (A must be complete) and ends with one (the ring
// and A may be rewritten after it).
template <int MT, int KS, int NA, int... Slot>
__device__ __forceinline__ void tile_product_bf(
    const bf16* a, int lda, int K, const bf16* const (&w)[sizeof...(Slot)],
    int ldw, int wcols, bf16* ring, float (&acc)[NA][MT][2][4]) {
  constexpr int G = sizeof...(Slot);
  constexpr int slot[G] = {Slot...};
  const int ws = G * wcols + kBfPad;     // ring row stride: no bank conflicts
  const int slot_elems = KS * ws;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int chunks = wcols / 8;          // 16-byte chunks a window row
  const int steps = (K + KS - 1) / KS;
  auto stage = [&](int s) {
    if (s < steps) {
      bf16* dst = ring + (s % kRingSlots) * slot_elems;
      const int k0 = s * KS, rows = min(KS, K - k0);
#pragma unroll
      for (int g = 0; g < G; ++g)
        for (int i = tid; i < rows * chunks; i += nthreads) {
          const int r = i / chunks, q = i - r * chunks;
          cp_async16_b(dst + r * ws + g * wcols + 8 * q,
                       w[g] + (long long)(k0 + r) * ldw + 8 * q, true);
        }
    }
    cp_async_commit();
  };
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kRingSlots - 1; ++s) stage(s);
  const bf16* ap = frag_ptr(a, lda);
  const bf16* bp = frag_ptr(ring, ws) + warp_col0();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRingSlots - 2>();
    __syncthreads();
    stage(s + kRingSlots - 1);
    const int k0 = s * KS, kn = min(KS, K - k0);
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      if (kk >= kn) break;
      unsigned fa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(fa[mt], ap + mt * 16 * lda + k0 + kk);
      const bf16* bs = bp + (s % kRingSlots) * slot_elems + kk * ws;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        unsigned fb[4];
        ldsm_x4_t(fb, bs + g * wcols);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[slot[g]][mt][0], fa[mt], fb[0], fb[1]);
          mma_bf16(acc[slot[g]][mt][1], fa[mt], fb[2], fb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A tile row's previous state: where it starts in prev (elements), and
// its live and decay factors. 16 bytes.
struct RowInfo {
  long long off;
  float live, dec;
};

// The RowInfo of rows a0..a0+nrows-1 of element b at step p.k, by threads
// 0..nrows-1 (rows past A: zeros). No barrier.
__device__ __forceinline__ void row_info(const Layer& p, int b, int a0,
                                         int nrows, RowInfo* ri) {
  const int r = threadIdx.x;
  if (r >= nrows) return;
  const long long elem_row = (long long)b * p.L1 * p.A;
  const long long row = elem_row + (long long)p.k * p.A + a0 + r;
  RowInfo v = {0, 0.f, 0.f};
  if (a0 + r < p.A) {
    v.off = prev_row(p, elem_row, row) * p.d;
    v.live = live_of(p, row);
    v.dec = expf(-p.lam * p.dt[row]);
  }
  ri[r] = v;
}

// The layer's input rows a0..a0+nrows-1 of element b at step p.k
// (bfloat16) into xs (row stride ld) by cp.async, 16 bytes a copy; rows
// past A zeros. Commits the copies; no wait.
__device__ __forceinline__ void copy_x_bf(const Layer& p, int b, int a0,
                                          int nrows, int ld, bf16* xs) {
  const int d = p.d, chunks = d / 8;
  const long long step_row = ((long long)b * p.L1 + p.k) * p.A;
  const bf16* x = reinterpret_cast<const bf16*>(p.x);
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, q = i - r * chunks;
    const bool in = a0 + r < p.A;
    cp_async16_b(xs + r * ld + 8 * q,
                 x + (step_row + (in ? a0 + r : 0)) * d + 8 * q, in);
  }
  cp_async_commit();
}

// The previous states of the tile's rows (bfloat16, as stored) into hs
// (row stride ld) by cp.async, at the offsets of ri; rows past A zeros.
// Commits the copies; no wait.
__device__ __forceinline__ void copy_prev_bf(const Layer& p, int a0,
                                             int nrows, int ld,
                                             const RowInfo* ri, bf16* hs) {
  const int d = p.d, chunks = d / 8;
  const bf16* prev = reinterpret_cast<const bf16*>(p.prev);
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, q = i - r * chunks;
    const bool in = a0 + r < p.A;
    cp_async16_b(hs + r * ld + 8 * q, prev + (in ? ri[r].off : 0) + 8 * q,
                 in);
  }
  cp_async_commit();
}

// After copy_prev_bf: waits for the thread's copies and scales the values
// it copied by live * exp(-lambda * dt), (prev * live) * decay as the TPU
// kernel, rounded back to bfloat16 in place: the gate product's operand.
// No barrier (each thread rewrites only what it copied).
__device__ __forceinline__ void decay_prev_bf(int nrows, int d, int ld,
                                              const RowInfo* ri, bf16* hs) {
  const int chunks = d / 8;
  cp_async_wait<0>();
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, q = i - r * chunks;
    const float lv = ri[r].live, dc = ri[r].dec;
    uint4 v = *reinterpret_cast<const uint4*>(hs + r * ld + 8 * q);
    unsigned* u = &v.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16(u[j]);
      u[j] = pack_bf16(f.x * lv * dc, f.y * lv * dc);
    }
    *reinterpret_cast<uint4*>(hs + r * ld + 8 * q) = v;
  }
}

// The float32 decayed state of tile row r at column c: the stored
// bfloat16 state times live and decay, as the TPU kernel's h0g, which the
// GRU blend and d_z read unrounded.
__device__ __forceinline__ float prev_f32(const Layer& p, const RowInfo* ri,
                                          int r, int c) {
  const bf16* prev = reinterpret_cast<const bf16*>(p.prev);
  return __bfloat162float(prev[ri[r].off + c]) * ri[r].live * ri[r].dec;
}

// The conv output of the tile's MT * 16 rows (a0.. of element b): the SpMM
// rows S (float32, row stride ldf; complete at the first product's opening
// barrier) + (xs @ loop) * mask, then the ReLU when p.relu, wcols columns
// at a time (tile_product_bf over p.loopw, bfloat16 [d, d], ring slots of
// KS rows); rounded into
// cs (row stride ld) at the thread's accumulator positions, and at the
// columns keep_s0.. the thread's float32 values into keep. The sums and
// their order are K2f's and K2b's alike.
template <int MT, int KS>
__device__ __forceinline__ void conv_tc_bf(const Layer& p, int b, int a0,
                                           const bf16* xs, bf16* cs,
                                           const float* S, int ld, int ldf,
                                           bf16* ring, int wcols, int keep_s0,
                                           float (&keep)[MT][2][4]) {
  const int d = p.d, A = p.A, c0 = warp_col0();
  const long long step_row = ((long long)b * p.L1 + p.k) * A;
  const bf16* loop = reinterpret_cast<const bf16*>(p.loopw);
  for (int s0 = 0; s0 < d; s0 += wcols) {
    float lp[1][MT][2][4] = {};
    const bf16* wl[1] = {loop + s0};
    tile_product_bf<MT, KS, 1, 0>(xs, ld, d, wl, d, wcols, ring, lp);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(mt, i), c = s0 + c0 + acc_col(nt, i);
          float v = lp[0][mt][nt][i];
          if (p.mask != nullptr && a0 + r < A)
            v *= p.mask[(step_row + a0 + r) * d + c];
          v += S[r * ldf + c];
          v = p.relu ? fmaxf(v, 0.f) : v;
          cs[r * ld + c] = __float2bfloat16_rn(v);
          if (s0 == keep_s0) keep[mt][nt][i] = v;
        }
  }
}

// The gates at accumulator position (mt, nt, i) of the gate products (acc
// 0 = gi_r + gh_r, 1 = gi_z + gh_z, 2 = gi_n, 3 = gh_n), with the biases
// of gate_bias: rgcn_gru_layer.cuh's gate_at for MT m16 tiles.
template <int MT>
__device__ __forceinline__ GateAt gate_at_bf(const float (&acc)[4][MT][2][4],
                                             int mt, int nt, int i,
                                             const GateBias& gb) {
  const int h = i & 1;
  GateAt g;
  g.r = sigmoid(acc[0][mt][nt][i] + gb.r[nt][h]);
  g.z = sigmoid(acc[1][mt][nt][i] + gb.z[nt][h]);
  g.ghn = acc[3][mt][nt][i] + gb.hn[nt][h];
  g.n = tanhf((acc[2][mt][nt][i] + gb.in[nt][h]) + g.r * g.ghn);
  return g;
}

// The gate products of a tile at columns s0..s0+wcols-1 of each gate into
// acc (zeroed here): cin @ W_ih^T's windows, then the previous states
// copied by copy_prev_bf (committed before the call) decayed in place and
// hs @ W_hh^T's. wih_t, whh_t: bfloat16 [d, 3d]; ring slots of KS rows.
// Ends with a barrier.
template <int MT, int KS>
__device__ __forceinline__ void gate_products_bf(
    const Layer& p, const bf16* cin, bf16* hs, int ld, const RowInfo* ri,
    int nrows, int s0, int wcols, bf16* ring, float (&acc)[4][MT][2][4]) {
  const int d = p.d;
  const bf16* wih_t = reinterpret_cast<const bf16*>(p.wih_t);
  const bf16* whh_t = reinterpret_cast<const bf16*>(p.whh_t);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][mt][nt][i] = 0.f;
  const bf16* wi[3] = {wih_t + s0, wih_t + d + s0, wih_t + 2 * d + s0};
  tile_product_bf<MT, KS, 4, 0, 1, 2>(cin, ld, d, wi, 3 * d, wcols, ring,
                                      acc);
  decay_prev_bf(nrows, d, ld, ri, hs);
  const bf16* wh[3] = {whh_t + s0, whh_t + d + s0, whh_t + 2 * d + s0};
  tile_product_bf<MT, KS, 4, 0, 1, 3>(hs, ld, d, wh, 3 * d, wcols, ring,
                                      acc);
}

// Shared memory of fwd_layer_tile_bf in bytes: the ring of three gate
// windows of the slab (slots of kFwdKs rows); xs and cs (bfloat16 rows);
// the float32 SpMM rows, whose place the previous states (bfloat16) take
// after the conv; the rows' RowInfo. 73,216 bytes at d = 128 and a
// 64-column slab.
__host__ __device__ constexpr int fwd_layer_bf_smem_bytes(int d, int warps) {
  return bf_ring_bytes(3, 16 * warps, kFwdKs) +
         2 * bf_rows_bytes(kBwdRows, d) +
         f32_rows_bytes(kBwdRows, d) + kBwdRows * 16;
}

// K2f's forward layer in bfloat16 for the kBwdRows rows a0.. of element b
// at the block_cols() columns s0.. of every gate (rgcn_gru_layer.cuh's
// fwd_layer_tile, natively): out(row, c, h, conv) at each of the thread's
// accumulator positions inside the layer, h the GRU's output and conv the
// float32 conv output there. p.x is bfloat16; p.loopw, p.wih_t, p.whh_t
// are the wrapper's bfloat16 copies.
template <typename Out>
__device__ __forceinline__ void fwd_layer_tile_bf(const Layer& p, int b,
                                                  int a0, int s0, Out&& out) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int MT = kBwdRows / 16;
  const int d = p.d, A = p.A, ld = d + kBfPad, ldf = d + 4;
  const int w = block_cols(), c0 = warp_col0();
  bf16* ring = reinterpret_cast<bf16*>(smem_b);
  bf16* xs = ring + bf_ring_bytes(3, w, kFwdKs) / 2;
  bf16* cs = xs + kBwdRows * ld;
  float* S = reinterpret_cast<float*>(cs + kBwdRows * ld);
  bf16* hs = reinterpret_cast<bf16*>(S);  // after the conv
  RowInfo* ri = reinterpret_cast<RowInfo*>(S + kBwdRows * ldf);
  const long long step_row = ((long long)b * p.L1 + p.k) * A;
  row_info(p, b, a0, kBwdRows, ri);
  copy_x_bf(p, b, a0, kBwdRows, ld, xs);
  __syncthreads();                      // ri
  float keep[MT][2][4] = {};
  if (!p.conv_given) {
    spmm_rows(p, b, a0, kBwdRows, S, ldf, nullptr);
    conv_tc_bf<MT, kFwdKs>(p, b, a0, xs, cs, S, ld, ldf, ring, w, s0, keep);
    __syncthreads();                    // S read: hs takes its place
  }
  copy_prev_bf(p, a0, kBwdRows, ld, ri, hs);
  const bf16* cin = p.conv_given ? xs : cs;
  float acc[4][MT][2][4];
  gate_products_bf<MT, kFwdKs>(p, cin, hs, ld, ri, kBwdRows, s0, w, ring,
                               acc);
  const GateBias gb = gate_bias(p.bih, p.bhh, d, s0 + c0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = s0 + c0 + acc_col(nt, i);
        if (a0 + r >= A) continue;
        const GateAt g = gate_at_bf<MT>(acc, mt, nt, i, gb);
        const float h = prev_f32(p, ri, r, c);
        const float conv =
            p.conv_given ? __bfloat162float(xs[r * ld + c]) : keep[mt][nt][i];
        out(step_row + a0 + r, c, (1.f - g.z) * g.n + g.z * h, conv);
      }
}

// Shared memory of bwd_gru_tile_bf in bytes: the ring (three gate windows
// of all d columns in slots of kBfKs rows, or two in slots of kGruKs);
// the tile region (xs, cs, the float32 SpMM rows then the previous states;
// later dg, [kBfBwdRows, 4d + 8] bfloat16, over them); the rows' RowInfo.
// 68,096 bytes at d = 128.
__host__ __device__ constexpr int bwd_gru_bf_region_bytes(int d) {
  return 2 * bf_rows_bytes(kBfBwdRows, d) + f32_rows_bytes(kBfBwdRows, d) >
                 kBfBwdRows * (4 * d + kBfPad) * 2
             ? 2 * bf_rows_bytes(kBfBwdRows, d) +
                   f32_rows_bytes(kBfBwdRows, d)
             : kBfBwdRows * (4 * d + kBfPad) * 2;
}

__host__ __device__ constexpr int bwd_gru_bf_ring_bytes(int d) {
  return bf_ring_bytes(3, d, kBfKs) > bf_ring_bytes(2, d, kGruKs)
             ? bf_ring_bytes(3, d, kBfKs)
             : bf_ring_bytes(2, d, kGruKs);
}

__host__ __device__ constexpr int bwd_gru_bf_smem_bytes(int d) {
  return bwd_gru_bf_ring_bytes(d) + bwd_gru_bf_region_bytes(d) +
         kBfBwdRows * 16;
}

// The gate cotangents' products of a GRU tile of MT * 16 rows (K2b's and
// K5's GRU tile, each direction of K9+K10's): the cotangents in acc (0 d_r,
// 1 d_z, 2 d_n, 3 d_ghn; float32 at the thread's accumulator positions)
// rounded into dg ([MT * 16, 4d] bfloat16, row stride ldg, over shared
// memory that nothing reads after the barrier here), then dx[0] += d_gi @
// W_ih and dx[1] += d_gh @ W_hh (wih, whh: bfloat16 [3d, d]), a gate
// section of the depth at a time. Ends with a barrier.
template <int MT>
__device__ __forceinline__ void gate_cotangent_products_bf(
    const float (&acc)[4][MT][2][4], const bf16* wih, const bf16* whh,
    int d, bf16* dg, int ldg, bf16* ring, float (&dx)[2][MT][2][4]) {
  const int c0 = warp_col0();
  __syncthreads();                      // dg overwrites the tile's rows
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dg[acc_row(mt, i) * ldg + j * d + c0 + acc_col(nt, i)] =
              __float2bfloat16_rn(acc[j][mt][nt][i]);
  const long long dd = (long long)d * d;
  const bf16* wr[2] = {wih, whh};
  tile_product_bf<MT, kGruKs, 2, 0, 1>(dg, ldg, d, wr, d, d, ring, dx);
  const bf16* wz[2] = {wih + dd, whh + dd};
  tile_product_bf<MT, kGruKs, 2, 0, 1>(dg + d, ldg, d, wz, d, d, ring, dx);
  const bf16* wn[1] = {wih + 2 * dd};
  tile_product_bf<MT, kGruKs, 2, 0>(dg + 2 * d, ldg, d, wn, d, d, ring, dx);
  const bf16* wh[1] = {whh + 2 * dd};
  tile_product_bf<MT, kGruKs, 2, 1>(dg + 3 * d, ldg, d, wh, d, d, ring, dx);
}

// K2b's and K5's GRU tile in bfloat16 (rgcn_gru_layer.cuh's bwd_gru_tile,
// natively) for kBfBwdRows rows (blockIdx.x) of element blockIdx.y, d / 16
// warps: recomputes the conv output and the gates with K2f's routines (the
// same sums, so the same values), then from d_out (db) the gate
// cotangents: float32 into dgi_s and dgh_s (the weight launch's bias sums
// read them unrounded), rounded into dg for d_gi @ W_ih and d_gh @ W_hh
// (wih, whh: bfloat16 [3d, d]); d_conv (+ g_loc, through the ReLU's mask)
// into dconv_s, d_conv * mask into dlp_s, the conv output and the decayed
// state into conv_s and h0g_s (bfloat16: the weight launch reads them
// rounded); the previous state's cotangent written to dprev at the row
// itself when dprev is not null (K5: the final step's d_hist), else added
// into db at the row gidx names (K2b; dead rows add nothing).
__device__ __forceinline__ void bwd_gru_tile_bf(
    const Layer& p, const bf16* __restrict__ wih,
    const bf16* __restrict__ whh, float* db, const float* __restrict__ g_loc,
    float* __restrict__ dprev, float* n2_out, bf16* __restrict__ conv_s,
    bf16* __restrict__ h0g_s, float* __restrict__ dgi_s,
    float* __restrict__ dgh_s, float* __restrict__ dconv_s,
    float* __restrict__ dlp_s) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int MT = kBfBwdRows / 16, R = kBfBwdRows;
  const int d = p.d, A = p.A, d3 = 3 * d;
  const int ld = d + kBfPad, ldf = d + 4, ldg = 4 * d + kBfPad;
  bf16* ring = reinterpret_cast<bf16*>(smem_b);
  bf16* xs = ring + bwd_gru_bf_ring_bytes(d) / 2;
  bf16* cs = xs + R * ld;
  float* S = reinterpret_cast<float*>(cs + R * ld);
  bf16* hs = reinterpret_cast<bf16*>(S);
  bf16* dg = xs;                        // [R, 4d]: d_r, d_z, d_n, d_ghn
  RowInfo* ri = reinterpret_cast<RowInfo*>(
      reinterpret_cast<unsigned char*>(xs) + bwd_gru_bf_region_bytes(d));
  const int b = blockIdx.y, a0 = blockIdx.x * R, c0 = warp_col0();
  const long long step_row = ((long long)b * p.L1 + p.k) * A;

  row_info(p, b, a0, R, ri);
  copy_x_bf(p, b, a0, R, ld, xs);
  __syncthreads();                      // ri
  spmm_rows(p, b, a0, R, S, ldf, n2_out);
  float cv[MT][2][4];
  conv_tc_bf<MT, kGruKs>(p, b, a0, xs, cs, S, ld, ldf, ring, d, 0, cv);
  __syncthreads();                      // S read: hs takes its place
  copy_prev_bf(p, a0, R, ld, ri, hs);
  float acc[4][MT][2][4];
  gate_products_bf<MT, kBfKs>(p, cs, hs, ld, ri, R, 0, d, ring, acc);
  const GateBias gb = gate_bias(p.bih, p.bhh, d, c0);
  float dh_direct[MT][2][4];
  unsigned pos_bits = 0;                // conv output > 0, by position
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        const float conv = cv[mt][nt][i];
        if (conv > 0.f) pos_bits |= 1u << ((mt * 2 + nt) * 4 + i);
        float pr = 0.f, pz = 0.f, pn = 0.f, phn = 0.f, dhd = 0.f;
        if (a < A) {
          const long long row = step_row + a;
          const long long m = (long long)b * A + a;
          const GateAt g = gate_at_bf<MT>(acc, mt, nt, i, gb);
          const float rg = g.r, z = g.z, n = g.n, ghn = g.ghn;
          const float dout = db[row * d + c];
          const float h = prev_f32(p, ri, r, c);
          const float dz = dout * (h - n);
          const float dn = dout * (1.f - z);
          dhd = dout * z;
          pn = dn * (1.f - n * n);
          phn = pn * rg;
          pr = pn * ghn * rg * (1.f - rg);
          pz = dz * z * (1.f - z);
          conv_s[m * d + c] = __float2bfloat16_rn(conv);
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
  // d_conv = d_gi @ W_ih (dx 0), d_h0g += d_gh @ W_hh (dx 1); dg over xs,
  // cs and hs
  float dx[2][MT][2][4] = {};
  gate_cotangent_products_bf<MT>(acc, wih, whh, d, dg, ldg, ring, dx);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        if (a >= A) continue;
        const long long row = step_row + a;
        const long long m = (long long)b * A + a;
        float dc = dx[0][mt][nt][i];
        if (g_loc != nullptr) dc += g_loc[row * d + c];
        if (p.relu && !((pos_bits >> ((mt * 2 + nt) * 4 + i)) & 1u)) dc = 0.f;
        dconv_s[m * d + c] = dc;
        dlp_s[m * d + c] = p.mask != nullptr ? dc * p.mask[row * d + c] : dc;
        const float lv = ri[r].live, dec = ri[r].dec;
        const float dh = dh_direct[mt][nt][i] + dx[1][mt][nt][i];
        if (dprev != nullptr)
          dprev[row * d + c] = dh * dec * lv;
        else if (lv != 0.f)
          db[ri[r].off + c] += dh * dec * lv;
      }
}

// Shared memory of bwd_input_tile_bf in bytes: the ring of one window of d
// columns, then ls (bfloat16 rows) and cs (float32 rows).
__host__ __device__ constexpr int bwd_input_bf_smem_bytes(int d) {
  return bf_ring_bytes(1, d, kInKs) + bf_rows_bytes(kBwdRows, d) +
         f32_rows_bytes(kBwdRows, d);
}

// K2b's and K5's (so K9+K10's) input tile in bfloat16 (rgcn_gru_layer.cuh's
// bwd_input_tile, natively) for kBwdRows rows (blockIdx.x) of element
// blockIdx.y, d / 16 warps: out = (base + SpMM^T of d_conv) + round(d_lp)
// @ loop^T (loop_t: bfloat16 [d, d]); x, the layer's input, bfloat16; each
// unmasked edge's relation-weight cotangent into ewg. The SpMM^T with the
// TPU kernel's casts (n2 holds norm, spmm_rows's bfloat16 output): the
// message cotangent round(d_conv[dst] * norm[dst]), then each source term
// round(d_msg * round(w) * (norm * em)) summed and each relation term
// round(d_msg * x[src] * (norm * em)).
__device__ __forceinline__ void bwd_input_tile_bf(
    const int* __restrict__ s_ptr, const int* __restrict__ s_dst,
    const int* __restrict__ s_rel, const float* __restrict__ s_em,
    const int* __restrict__ s_eid, const float* __restrict__ n2,
    const float* __restrict__ dconv_s, const float* __restrict__ dlp_s,
    const float* __restrict__ wrel, int wstride, int wcol,
    const bf16* __restrict__ loop_t, const bf16* __restrict__ x,
    float* __restrict__ ewg, float* out, int accumulate, int L1, int A, int d,
    int k) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  constexpr int MT = kBwdRows / 16;
  const int ld = d + kBfPad, ldf = d + 4;
  bf16* ring = reinterpret_cast<bf16*>(smem_b);
  bf16* ls = ring + bf_ring_bytes(1, d, kInKs) / 2;  // d_lp rows, rounded
  float* cs = reinterpret_cast<float*>(ls + kBwdRows * ld);  // SpMM^T rows
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kBwdRows;
  const long long step_row = ((long long)b * L1 + k) * A;
  const int tid = threadIdx.x, nthreads = blockDim.x, quads = d / 4;
  for (int i = tid; i < kBwdRows * quads; i += nthreads) {
    const int r = i / quads, q = i - r * quads;
    const int a = a0 + r;
    const float4 v =
        a < A ? *reinterpret_cast<const float4*>(
                    dlp_s + ((long long)b * A + a) * d + 4 * q)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<uint2*>(ls + r * ld + 4 * q) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int nwarps = (nthreads + kWarp - 1) / kWarp;
  for (int r = warp; r < kBwdRows; r += nwarps) {
    const int a = a0 + r;
    float acc[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) acc[j] = 0.f;
    if (a < A) {
      const long long row = step_row + a;
      const bf16* xr = x + row * d;
      const int e1 = s_ptr[row + 1];
      for (int e = s_ptr[row]; e < e1; ++e) {
        const int t = s_dst[e];
        // s = norm[dst] * em; n2 holds norm in this mode
        const float s = n2[step_row + t] * s_em[e];
        const float* gt = dconv_s + ((long long)b * A + t) * d;
        const float* wr = wrel + (long long)s_rel[e] * wstride + wcol;
        float* er = ewg + (long long)s_eid[e] * d;
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {
          const int c = lane + j * kWarp;
          if (c < d) {
            const float dm = round_bf16(gt[c] * n2[step_row + t]);
            acc[j] += round_bf16(dm * round_bf16(wr[c]) * s);
            er[c] = round_bf16(dm * __bfloat162float(xr[c]) * s);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) cs[r * ldf + c] = acc[j];
    }
  }

  float lp[1][MT][2][4] = {};
  const bf16* w[1] = {loop_t};
  tile_product_bf<MT, kInKs, 1, 0>(ls, ld, d, w, d, d, ring, lp);
  const int c0 = warp_col0();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        if (a >= A) continue;
        float* o = out + (step_row + a) * d + c;
        const float base = accumulate ? *o : 0.f;
        *o = (base + cs[r * ldf + c]) + lp[0][mt][nt][i];
      }
}

// Weight cotangents in bfloat16 (rgcn_gru_layer.cuh's wgrad_tile,
// natively): out[x_col, g_col] += sum over the range's rows of
// round(X[row, x_col]) * round(G[row, g_col]), bias[g_col] += sum of the
// unrounded G. X is bfloat16 in device memory (the conv output and decayed
// states of the GRU tiles, layer 1's buffer, the layer-1 input), G float32
// (the gate cotangents, d_lp). A range's X rows stream through a ring of
// kWgSlots bfloat16 slots, its G rows through a ring of float32 slots
// (cp.async); each thread rounds the G values it copied into one of two
// bfloat16 slots, which the barrier of the step publishes, and the bias
// reads the float32 slot. The product: X^T's fragments by ldmatrix.trans
// (X's depth-major rows), G's likewise, mma.sync m16n8k16, four warps of 32
// x 32; two k16 steps a slot of kWgK rows.
struct WJobBf {
  const bf16* x;       // row (b, a) at x + b * x_es + a * nx
  long long x_es;
  const float* g;      // row (b, a) at g + b * g_es + a * ng
  long long g_es;
  float* out;          // [nx, ng] in range 0's copy
  float* bias;         // [ng] or null
  int nx, ng, tiles_g, first;
};

struct WJobsBf {
  WJobBf job[kWgJobs];
};

constexpr int kWgLdB = kWgM + kBfPad;     // bfloat16 slot row stride
constexpr int kWgSmemBytesBf =
    kWgSlots * kWgK * kWgLd * 4 +         // G rows, float32
    kWgSlots * kWgK * kWgLdB * 2 +        // X rows, bfloat16
    2 * kWgK * kWgLdB * 2;                // G rows rounded, two slots

__device__ __forceinline__ void wgrad_tile_bf(const WJobsBf& jobs, int B,
                                              int A, int rows_per_split,
                                              long long part_stride) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* gring = reinterpret_cast<float*>(smem_b);
  bf16* xring = reinterpret_cast<bf16*>(gring + kWgSlots * kWgK * kWgLd);
  bf16* gbf = xring + kWgSlots * kWgK * kWgLdB;
  int j = 0;
  while (j + 1 < kWgJobs && (int)blockIdx.x >= jobs.job[j + 1].first) ++j;
  const WJobBf jb = jobs.job[j];
  const int t = blockIdx.x - jb.first;
  const int tx0 = (t / jb.tiles_g) * kWgM;
  const int tg0 = (t % jb.tiles_g) * kWgN;
  const int tid = threadIdx.x, warp = tid / kWarp;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m_begin = blockIdx.y * rows_per_split;
  const int m_end = min(B * A, m_begin + rows_per_split);
  const int steps = m_end > m_begin ? (m_end - m_begin + kWgK - 1) / kWgK : 0;
  const bool x_rows = tx0 + wm < jb.nx;      // the warp has x columns
  const bool bias_sum = jb.bias != nullptr && tx0 == 0 && tid < kWgN;
  constexpr int kQ = kWgN / 4;                // float32 chunks a G row
  float acc[2][4][4] = {};
  float bsum = 0.f;

  auto stage = [&](int s) {
    if (s < steps) {
      float* gs = gring + (s % kWgSlots) * kWgK * kWgLd;
      bf16* xs = xring + (s % kWgSlots) * kWgK * kWgLdB;
      const int m0 = m_begin + s * kWgK;
      for (int i = tid; i < kWgK * kQ; i += kWgThreads) {
        const int r = i / kQ, q = i % kQ;
        const int m = m0 + r;
        const int b = m / A, a = m - b * A;
        const int gc = tg0 + 4 * q;
        const bool gv = m < m_end && gc < jb.ng;
        cp_async16(gs + r * kWgLd + 4 * q,
                   gv ? jb.g + b * jb.g_es + (long long)a * jb.ng + gc : jb.g,
                   gv);
        if (q < kWgM / 8) {
          const int xc = tx0 + 8 * q;
          const bool xv = m < m_end && xc < jb.nx;
          cp_async16_b(xs + r * kWgLdB + 8 * q,
                       xv ? jb.x + b * jb.x_es + (long long)a * jb.nx + xc
                          : jb.x,
                       xv);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kWgSlots - 1; ++s) stage(s);
  const bf16* xa = frag_ptr_t(xring, kWgLdB) + wm;
  const bf16* gb = frag_ptr(gbf, kWgLdB) + wn;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWgSlots - 2>();
    const float* gs = gring + (s % kWgSlots) * kWgK * kWgLd;
    bf16* gr = gbf + (s % 2) * kWgK * kWgLdB;
    for (int i = tid; i < kWgK * kQ; i += kWgThreads) {
      const int r = i / kQ, q = i % kQ;
      const float4 v = *reinterpret_cast<const float4*>(gs + r * kWgLd +
                                                        4 * q);
      *reinterpret_cast<uint2*>(gr + r * kWgLdB + 4 * q) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    __syncthreads();
    stage(s + kWgSlots - 1);
    if (x_rows) {
      const bf16* xsl = xa + (s % kWgSlots) * kWgK * kWgLdB;
      const bf16* gsl = gb + (s % 2) * kWgK * kWgLdB;
#pragma unroll
      for (int k0 = 0; k0 < kWgK; k0 += 16) {
        unsigned fa[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4_t(fa[mt], xsl + k0 * kWgLdB + mt * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned fb[4];
          ldsm_x4_t(fb, gsl + k0 * kWgLdB + np * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
            mma_bf16(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
          }
        }
      }
    }
    if (bias_sum) {
      float slot_sum = 0.f;
      for (int r = 0; r < kWgK; ++r) slot_sum += gs[r * kWgLd + tid];
      bsum += slot_sum;
    }
  }
  cp_async_wait<0>();

  const long long off = (long long)blockIdx.y * part_stride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xc = tx0 + wm + acc_row(mt, i);
        const int gc = tg0 + wn + nt * 8 + 2 * (tid & 3) + (i & 1);
        if (xc < jb.nx && gc < jb.ng)
          jb.out[off + (long long)xc * jb.ng + gc] += acc[mt][nt][i];
      }
  if (bias_sum && tg0 + tid < jb.ng) jb.bias[off + tg0 + tid] += bsum;
}

WJobBf make_job_bf(const bf16* x, long long x_es, const void* g,
                   long long g_es, float* out, float* bias, int nx, int ng,
                   int* first) {
  WJobBf jb;
  jb.x = x;
  jb.x_es = x_es;
  jb.g = static_cast<const float*>(g);
  jb.g_es = g_es;
  jb.out = out;
  jb.bias = bias;
  jb.nx = nx;
  jb.ng = ng;
  jb.tiles_g = (ng + kWgN - 1) / kWgN;
  jb.first = *first;
  const int tiles_x = nx > 0 ? (nx + kWgM - 1) / kWgM : 1;
  *first += tiles_x * jb.tiles_g;
  return jb;
}

// A launch's grid, threads a block and shared memory a block in bytes.
struct Shape {
  dim3 grid;
  int threads, bytes;
};

// A whole-width tile launch over A rows of B elements: tiles of `rows`
// rows, d / 16 warps, `bytes` of shared memory a block.
inline Shape tile_shape(int B, int A, int d, int rows, int bytes) {
  return {dim3((A + rows - 1) / rows, B), 2 * d, bytes};
}

inline Shape bwd_gru_shape(int B, int A, int d) {
  return tile_shape(B, A, d, kBfBwdRows, bwd_gru_bf_smem_bytes(d));
}

inline Shape bwd_input_shape(int B, int A, int d) {
  return tile_shape(B, A, d, kBwdRows, bwd_input_bf_smem_bytes(d));
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// A kernel's launch shape and occupancy: out[0] its shared memory a block
// in bytes, out[1] its threads, out[2] the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); with n = 5 also out[3]
// its registers a thread and out[4] its local memory a thread in bytes
// (the spills' and stack's).
template <typename K>
cudaError_t occupancy(K kernel, int threads, int bytes, int* out,
                      int n = 3) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, bytes);
  out[0] = bytes;
  out[1] = threads;
  out[2] = blocks;
  if (err != cudaSuccess || n < 5) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace
