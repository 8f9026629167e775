// One RGCN+GRU layer over a tile of rows, forward and backward: the device
// code that the window kernels (fused_window.cu, K2f/K2b), the final-step
// kernels (fused_final.cu, K3/K5) and the flagship's bidirectional
// final-step kernels (fused_final_bi.cu, K6-K10) share. Each .cu file
// includes it and wraps the bodies in kernels of its own names; the relation
// sum at the end is one kernel that all launch.
//
// A layer's rows are laid out [B, L1, A, d]: batch element b, window step k,
// row a. The window runs L1 steps of A active rows; the final step is one
// step (L1 = 1, k = 0) over all A = N entities, whose previous state is the
// same row of a dense history (gidx null) and always live (live null).
//
// The SpMMs and their transposes give one warp per row over a CSR of that
// step's edges, summing in registers without atomics. Every product runs
// on the tensor cores: tile_product (or wgrad_tile's own loop of the same
// parts) on mma.sync m16n8k8 in 3xTF32 at f32 accuracy, in 32-row tiles
// whose warps own 16 columns of every weight window and all the rows, the
// weights streamed through shared memory by cp.async, the outputs kept in
// mma accumulators. fwd_layer_tile is the forward layer of the window
// (K2f, and K12 on its launches) and of the final step (K3's two layer
// launches, which K11 makes too): a block works on a column slab of every
// gate, so that a window step's few thousand rows still fill the card, or
// on all d columns. The flagship's forward layer (bi_layer_kernel, K6+K7)
// and the backward tiles work on all d columns (bwd_gru_tile,
// bwd_input_tile, wgrad_tile: K2b and K5; K9+K10's own GRU tile
// bi_bwd_gru_kernel, its input and its weight launches). conv_rows_tc and
// gate_products are the forward products that every forward tile and the
// backward tiles' recompute share, so all give the same conv output and
// gates bit for bit. What bounds them is the tensor cores' mma.sync rate at
// three products for each f32 one, with the 3xTF32 splits and the staging
// beside it.
//
// The bfloat16 mode. A source that defines TK_BF16 to 1 before it includes
// this header (fused_final_bf16.cu: fused_final.cu compiled again for K3's
// score launch, K4 and K8; fused_window_bf16.cu, and the native K3 layer
// launches, K5, K6+K7 and K9+K10 in fused_final_bf16.cu and
// fused_final_bi_bf16.cu, for the SpMM, the layer description and the
// shared helpers only) gets the routines that mode still uses in the mode
// of the TPU kernels' bfloat16 instantiation (temp_tpu/ops/fused_final.py,
// fused_final_bi.py, fused_window.py with dtype_str "bfloat16"): each
// product operand of the score and cotangent products rounded to bfloat16
// (to nearest even) and kept as a float whose low 16 bits are zero, exact
// in TF32, so ONE mma.sync TF32 product a k8 step (split_tf32, mma3) gives
// the bfloat16 product with float32 sums; the SpMM rounds each gathered
// source row, relation weight and message (spmm_rows), where the TPU
// kernels' one-hot products round them, and reads a bfloat16 layer input
// (x_at, Layer::x_bf16). What bounds K3's score launch, K4 and K8 in
// bfloat16: TF32's 495 TFLOP/s, half of the tensor cores' bfloat16 rate,
// with every operand rounded again at every k8 step by every warp that
// loads it, and float32 staging. The layer tiles (load_tile, conv_rows_tc,
// gate_products, fwd_layer_tile and the backward tiles bwd_gru_tile,
// bwd_input_tile, wgrad_tile) exist in float32 only: every bfloat16 layer
// launch (K2f, K2b, K3's layers, K5, K6+K7, K9+K10, and K11's and K12's
// layers, which are K3's and K2f's) runs window_bf16.cuh's routines, which
// stage their operands once as bfloat16 and multiply them by mma.sync
// m16n8k16 bf16 (its note).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef TK_BF16
#define TK_BF16 0
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChunks = 8;                         // d <= 256
constexpr bool kBf16 = TK_BF16 != 0;

// x rounded to bfloat16 (to nearest, ties to even, as XLA's convert), as a
// float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as its bfloat16 rounding plus the bfloat16 rounding of the rest (about
// 16 significant bits): the TPU kernel's hi/lo split of the loss's gathered
// rows (temp_tpu/ops/fused_final.py _Final._gather_rows).
__device__ __forceinline__ float hilo_bf16(float x) {
  const float hi = round_bf16(x);
  return hi + round_bf16(x - hi);
}

// A value written to a buffer in the store dtype: bfloat16 in the
// bfloat16 mode, float otherwise.
__device__ __forceinline__ void store_out(float* base, long long i, float v) {
  if constexpr (kBf16)
    reinterpret_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  else
    base[i] = v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid
// (then nothing is read at src).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One RGCN+GRU layer of window step k.
struct Layer {
  const float* x;       // [B, L1, A, d] layer input
  int conv_given;       // x already holds the conv output (eval only)
  const int* rowptr;    // [B*L1*A + 1] CSR by (b, k, dst)
  const int* src;       // [B*L1*E] in CSR order, step-local rows
  const int* rel;
  const float* em;
  const float* wrel;    // [R, wstride]; this layer at column wcol
  int wstride, wcol;
  const float* loopw;   // [d, d]
  const float* mask;    // [B, L1, A, d] self-loop dropout mask / keep, or null
  int relu;             // ReLU on the conv output (layer 2 of the Bi models)
  const float* wih_t;   // [d, 3d]
  const float* whh_t;   // [d, 3d]
  const float* bih;     // [3d]
  const float* bhh;     // [3d]
  const int* gidx;      // [B, L1, A] row in the element's [L1*A] buffer, or
                        // null: the same row of prev
  const float* live;    // [B, L1, A], or null: every row live
  const float* dt;      // [B, L1, A]
  float lam;
  const float* prev;    // [B, L1, A, d] previous states (the window: this
                        // layer's output buffer; the final step: history);
                        // bfloat16 in the bfloat16 mode
  int L1, A, d, k;
  int x_bf16;           // x is bfloat16 (the bfloat16 mode only)
};

// Element i of the layer's input, as a float.
__device__ __forceinline__ float x_at(const Layer& p, long long i) {
  if constexpr (kBf16) {
    if (p.x_bf16)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.x)[i]);
  }
  return p.x[i];
}

// The row of prev that holds row `row`'s previous state, and its liveness.
__device__ __forceinline__ long long prev_row(const Layer& p,
                                              long long elem_row,
                                              long long row) {
  return p.gidx != nullptr ? elem_row + p.gidx[row] : row;
}

__device__ __forceinline__ float live_of(const Layer& p, long long row) {
  return p.live != nullptr ? p.live[row] : 1.f;
}

// The float32 tiles' loads (the bfloat16 mode's are window_bf16.cuh's).
#if !TK_BF16

// A window row's (or a final-step row's) previous state: where it starts
// in prev, and the live and decay factors it is scaled by.
struct PrevRow {
  long long off;
  float live, dec;
};

// Rows a0..a0+nrows-1 of element b into shared memory (row stride ld): xs
// = the input rows (cs too when the conv output is given, cs may be null
// otherwise), hs = the previous states times live * exp(-lambda * dt) (hs
// may be null). The rows are copied by cp.async, a warp a row, after each
// warp's lanes have read the gather index, live and dt of the warp's rows
// at once (lane i those of its i-th row); then each warp scales its rows of
// hs. So a row costs no chain of dependent loads. Rows past A are zeros.
// No barrier at the end (each warp's copies are complete).
__device__ __forceinline__ void load_tile(const Layer& p, int b, int a0,
                                          int nrows, int ld, float* xs,
                                          float* cs, float* hs) {
  constexpr unsigned kAll = 0xffffffffu;
  const int d = p.d, A = p.A, quads = d / 4;
  const long long elem_row = (long long)b * p.L1 * A;
  const long long step_row = elem_row + (long long)p.k * A;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  PrevRow mine = {0, 0.f, 0.f};
  {
    const int r = warp + lane * nwarps, a = a0 + r;
    if (r < nrows && a < A && hs != nullptr) {
      const long long row = step_row + a;
      mine.off = prev_row(p, elem_row, row) * d;
      mine.live = live_of(p, row);
      mine.dec = expf(-p.lam * p.dt[row]);
    }
  }
  for (int r = warp, i = 0; r < nrows; r += nwarps, ++i) {
    const bool in = a0 + r < A;
    const float* xr = p.x + (step_row + (in ? a0 + r : 0)) * d;
    const float* pr = p.prev + __shfl_sync(kAll, mine.off, i);
    for (int q = lane; q < quads; q += kWarp) {
      cp_async16(xs + r * ld + 4 * q, xr + 4 * q, in);
      if (p.conv_given) cp_async16(cs + r * ld + 4 * q, xr + 4 * q, in);
      if (hs != nullptr) cp_async16(hs + r * ld + 4 * q, pr + 4 * q, in);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  if (hs == nullptr) return;
  __syncwarp();
  for (int r = warp, i = 0; r < nrows; r += nwarps, ++i) {
    const float lv = __shfl_sync(kAll, mine.live, i);
    const float dec = __shfl_sync(kAll, mine.dec, i);
    for (int c = lane; c < d; c += kWarp)
      hs[r * ld + c] = hs[r * ld + c] * lv * dec;
  }
}

// The previous states of rows a0..a0+nrows-1 only (row stride ld; the
// second direction of a bidirectional layer, whose input rows are already
// loaded), as load_tile loads them, in two halves: copy_prev starts the
// copies by cp.async and commits them; decay_prev waits for every copy of
// the thread, then scales the rows by live * exp(-lambda * dt). Between
// the two the block may compute on other regions, so the copies run under
// that work. No barrier at the end of either.
__device__ __forceinline__ void copy_prev(const Layer& p, int b, int a0,
                                          int nrows, int ld, float* hs) {
  constexpr unsigned kAll = 0xffffffffu;
  const int d = p.d, A = p.A, quads = d / 4;
  const long long elem_row = (long long)b * p.L1 * A;
  const long long step_row = elem_row + (long long)p.k * A;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  long long off = 0;
  {
    const int r = warp + lane * nwarps, a = a0 + r;
    if (r < nrows && a < A) off = prev_row(p, elem_row, step_row + a) * d;
  }
  for (int r = warp, i = 0; r < nrows; r += nwarps, ++i) {
    const bool in = a0 + r < A;
    const float* pr = p.prev + __shfl_sync(kAll, off, i);
    for (int q = lane; q < quads; q += kWarp)
      cp_async16(hs + r * ld + 4 * q, pr + 4 * q, in);
  }
  cp_async_commit();
}

__device__ __forceinline__ void decay_prev(const Layer& p, int b, int a0,
                                           int nrows, int ld, float* hs) {
  constexpr unsigned kAll = 0xffffffffu;
  const int d = p.d, A = p.A;
  const long long step_row = ((long long)b * p.L1 + p.k) * A;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  float live = 0.f, dec = 0.f;
  {
    const int r = warp + lane * nwarps, a = a0 + r;
    if (r < nrows && a < A) {
      live = live_of(p, step_row + a);
      dec = expf(-p.lam * p.dt[step_row + a]);
    }
  }
  cp_async_wait<0>();
  __syncwarp();
  for (int r = warp, i = 0; r < nrows; r += nwarps, ++i) {
    const float lv = __shfl_sync(kAll, live, i);
    const float dc = __shfl_sync(kAll, dec, i);
    for (int c = lane; c < d; c += kWarp)
      hs[r * ld + c] = hs[r * ld + c] * lv * dc;
  }
}

#endif  // !TK_BF16

// The relational SpMM with double degree normalization of rows
// a0..a0+nrows-1 of element b (one warp a row) into cs (row stride ld);
// writes norm^2 of each row to n2_out when it is not null (the bfloat16
// mode: norm, which its transpose needs). No barrier.
//
// The bfloat16 mode sums, as the TPU kernel does, the messages
// round(round(h[src]) * round(w[rel]) * (norm * em)) and then scales the
// sum by norm: the degree first, then the messages.
__device__ __forceinline__ void spmm_rows(const Layer& p, int b, int a0,
                                          int nrows, float* cs, int ld,
                                          float* n2_out) {
  const int d = p.d, A = p.A;
  const long long step_row = ((long long)b * p.L1 + p.k) * A;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = (blockDim.x + kWarp - 1) / kWarp;
  if constexpr (kBf16) {
    for (int r = warp; r < nrows; r += nwarps) {
      const int a = a0 + r;
      float acc[kMaxChunks];
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) acc[j] = 0.f;
      float norm = 0.f;
      if (a < A) {
        const long long row = step_row + a;
        const int e0 = p.rowptr[row], e1 = p.rowptr[row + 1];
        float deg = 0.f;
        for (int e = e0; e < e1; ++e) deg += p.em[e];
        norm = deg > 0.f ? 1.f / deg : 0.f;
        for (int e = e0; e < e1; ++e) {
          const float es = norm * p.em[e];
          const long long hr = (step_row + p.src[e]) * d;
          const float* wr = p.wrel + (long long)p.rel[e] * p.wstride + p.wcol;
#pragma unroll
          for (int j = 0; j < kMaxChunks; ++j) {
            const int c = lane + j * kWarp;
            if (c < d) {
              const float hw = round_bf16(x_at(p, hr + c)) * round_bf16(wr[c]);
              acc[j] += round_bf16(hw * es);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = lane + j * kWarp;
        if (c < d) cs[r * ld + c] = acc[j] * norm;
      }
      if (n2_out != nullptr && lane == 0 && a < A) n2_out[step_row + a] = norm;
    }
    return;
  }
  for (int r = warp; r < nrows; r += nwarps) {
    const int a = a0 + r;
    float acc[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) acc[j] = 0.f;
    float deg = 0.f;
    if (a < A) {
      const long long row = step_row + a;
      const int e1 = p.rowptr[row + 1];
      for (int e = p.rowptr[row]; e < e1; ++e) {
        const float m = p.em[e];
        deg += m;
        const float* hsrc = p.x + (step_row + p.src[e]) * d;
        const float* wr = p.wrel + (long long)p.rel[e] * p.wstride + p.wcol;
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {
          const int c = lane + j * kWarp;
          if (c < d) acc[j] += hsrc[c] * wr[c] * m;
        }
      }
    }
    const float norm = deg > 0.f ? 1.f / deg : 0.f;
    const float n2 = norm * norm;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) cs[r * ld + c] = acc[j] * n2;
    }
    if (n2_out != nullptr && lane == 0 && a < A) n2_out[step_row + a] = n2;
  }
}

// -- The tensor-core tiles' products: 3xTF32 --------------------------------
//
// Every product of the tensor-core tiles (the self-loop and gate products
// of K2f and of the backward tiles' recompute, the transposed gate
// products, the input cotangent's d_lp @ loop^T and the weight cotangents
// X^T G) runs on mma.sync
// m16n8k8 with tf32 operands at f32 accuracy: each f32 operand x is split
// into hi, x with its 13 low mantissa bits cleared (the tiles) or rounded
// to tf32 (the weight launch), and lo = x - hi, exact in f32, of which the
// tensor core reads the top 11 significant bits. A k8 step adds lo*hi +
// hi*lo + hi*hi (the lo*lo term, under 2^-20 of the product, is dropped).
// The three products of a k8 step start from zero and their sum is added
// to the f32 accumulator with an ordinary rounded add, so the tensor
// cores' own truncating accumulation covers 8 terms at a time, never a
// long sum. Per product the error is then a few 2^-21 relative, within a
// small factor of f32's own rounding over the sums of 128-384 terms of the
// tiles; the weight launch's sums run over thousands of rows, and its
// rounded hi halves the error there (tests/test_torch_tf32x3.py holds a
// model of both to float64). The rounding conversions are the costly part:
// without them K5 took 3.28 ms where it took 3.70 on an H100 (PERF.md). In
// the bfloat16 mode (TK_BF16: K3's score launch, K4, K8) split_tf32 rounds
// each operand to bfloat16 and mma3 issues one TF32 product of them, so a
// product loop converts every fragment element at every k8 step: the cost
// that window_bf16.cuh's native bfloat16 products remove for the layer
// launches (K2, K3's layers, K5, K6+K7, K9+K10).

constexpr int kBwdRows = 32;               // rows a tensor-core tile
constexpr int kMTiles = kBwdRows / 16;     // m16 tiles a warp: all the rows
constexpr int kWarpCols = 16;              // columns a warp owns: two n8
constexpr int kKs = 8;                     // depth rows a ring slot holds
constexpr int kRingSlots = 3;

// x = hi + lo: hi rounded to tf32 (kRound) or truncated, lo the exact rest.
// The bfloat16 mode: hi = x rounded to bfloat16 (exact in tf32), lo unused.
template <bool kRound>
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  if constexpr (kBf16) {
    hi = __float_as_uint(round_bf16(x));
    lo = 0u;
    return;
  }
  if (kRound)
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  else
    hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An m16 x k8 operand of A and a k8 x n8 operand of B, split.
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

// acc += A B over one k8 step in 3xTF32; in the bfloat16 mode one TF32
// product of the rounded operands (exact products, float32 sums).
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a,
                                     const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kBf16) {
    mma_tf32(t, a.hi, b.hi[0], b.hi[1]);
  } else {
    mma_tf32(t, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(t, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(t, a.hi, b.hi[0], b.hi[1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// A's m16 x k8 operand at rows r0.., columns k0.. of a row-major [rows, ld]
// array in shared memory (the mma's row layout: lane g = lane / 4 holds rows
// g and g + 8, lane t = lane % 4 columns t and t + 4), its high parts
// truncated (the tiles).
__device__ __forceinline__ FragA frag_a_rows(const float* a, int ld, int r0,
                                             int k0) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const float* p = a + (r0 + g) * ld + k0 + t;
  FragA f;
  split_tf32<false>(p[0], f.hi[0], f.lo[0]);
  split_tf32<false>(p[8 * ld], f.hi[1], f.lo[1]);
  split_tf32<false>(p[4], f.hi[2], f.lo[2]);
  split_tf32<false>(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}

// The same operand from a depth-major [k, m] array (A transposed), its
// high parts rounded (the weight launch).
__device__ __forceinline__ FragA frag_a_depth(const float* a, int ld, int m0,
                                              int k0) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const float* p = a + (k0 + t) * ld + m0 + g;
  FragA f;
  split_tf32<true>(p[0], f.hi[0], f.lo[0]);
  split_tf32<true>(p[8], f.hi[1], f.lo[1]);
  split_tf32<true>(p[4 * ld], f.hi[2], f.lo[2]);
  split_tf32<true>(p[4 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}

// B's k8 x n8 operand at depth rows k0.., columns n0.. of a depth-major
// [k, n] array in shared memory, its high parts rounded when kRound.
template <bool kRound>
__device__ __forceinline__ FragB frag_b(const float* b, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const float* p = b + (k0 + t) * ld + n0 + g;
  FragB f;
  split_tf32<kRound>(p[0], f.hi[0], f.lo[0]);
  split_tf32<kRound>(p[4 * ld], f.hi[1], f.lo[1]);
  return f;
}

// B's k8 x n8 operand at depth columns k0.., columns n0.. of an [n, k]
// array in shared memory (B transposed: a row per column of the product,
// as the score tile's table rows), its high parts truncated.
__device__ __forceinline__ FragB frag_b_rows(const float* b, int ld, int k0,
                                             int n0) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const float* p = b + (n0 + g) * ld + k0 + t;
  FragB f;
  split_tf32<false>(p[0], f.hi[0], f.lo[0]);
  split_tf32<false>(p[4], f.hi[1], f.lo[1]);
  return f;
}

// The paired operands: a product whose depth slots t and t + 4 of a k8
// step hold the depth terms k0 + 2t and k0 + 2t + 1 (A and B take the same
// order, so the sum is the same one). A lane's two depth terms then sit
// side by side: in a row-major A one 8-byte load, and in a depth-major
// array rows 2t, 2t + 1, so rows of d + 4 floats give B conflict-free
// loads. High parts truncated, as the tiles'.
__device__ __forceinline__ FragA frag_a_pairs(const float* a, int ld, int r0,
                                              int k0) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const float* p = a + (r0 + g) * ld + k0 + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  FragA f;
  split_tf32<false>(v0.x, f.hi[0], f.lo[0]);
  split_tf32<false>(v1.x, f.hi[1], f.lo[1]);
  split_tf32<false>(v0.y, f.hi[2], f.lo[2]);
  split_tf32<false>(v1.y, f.hi[3], f.lo[3]);
  return f;
}

// The same order from a depth-major [k, m] array (A transposed).
__device__ __forceinline__ FragA frag_a_pairs_t(const float* a, int ld,
                                                int m0, int k0) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const float* p = a + (k0 + 2 * t) * ld + m0 + g;
  FragA f;
  split_tf32<false>(p[0], f.hi[0], f.lo[0]);
  split_tf32<false>(p[8], f.hi[1], f.lo[1]);
  split_tf32<false>(p[ld], f.hi[2], f.lo[2]);
  split_tf32<false>(p[ld + 8], f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b_pairs(const float* b, int ld, int k0,
                                              int n0) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const float* p = b + (k0 + 2 * t) * ld + n0 + g;
  FragB f;
  split_tf32<false>(p[0], f.hi[0], f.lo[0]);
  split_tf32<false>(p[ld], f.hi[1], f.lo[1]);
  return f;
}

// The first column of the warp's 16 in a backward tile.
__device__ __forceinline__ int warp_col0() {
  return (threadIdx.x / kWarp) * kWarpCols;
}

// The position of element i (0..3) of a thread's accumulator of tile
// (mt, nt): row within the block's kBwdRows, column within the warp's 16.
__device__ __forceinline__ int acc_row(int mt, int i) {
  return mt * 16 + ((threadIdx.x % kWarp) >> 2) + (i >= 2 ? 8 : 0);
}

__device__ __forceinline__ int acc_col(int nt, int i) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// Floats of the ring that streams G weight windows of d columns.
__host__ __device__ constexpr int ring_floats(int G, int d) {
  return kRingSlots * kKs * (G * d + 8);
}

// The float32 tiles' products (the bfloat16 mode's are window_bf16.cuh's).
#if !TK_BF16

// The block's product routine: acc[Slot_g] += A @ W_g for g < G, over the
// warp's 16 columns of each W_g. A: kBwdRows rows in shared memory
// (row-major, row stride lda, depth column 0 at a); W_g: [K, d] windows in
// device memory (row stride ldw, column 0 at w[g]). The K depth rows of the
// G windows stream through `ring` in slots of kKs rows (cp.async, kRingSlots
// slots in flight, one barrier a slot), so each weight element is read from
// device memory once a block and by the warp that owns its column from
// shared memory. Warp w owns columns 16w..16w+15 of every window and all the
// block's rows; the block has d / 16 warps and K is a multiple of 8. Starts
// with a barrier (A must be complete) and ends with one (the ring and A may
// be rewritten after it).
template <int NA, int... Slot>
__device__ __forceinline__ void tile_product(
    const float* a, int lda, int K,
    const float* const (&w)[sizeof...(Slot)], int ldw, int d, float* ring,
    float (&acc)[NA][kMTiles][2][4]) {
  constexpr int G = sizeof...(Slot);
  constexpr int slot[G] = {Slot...};
  const int ws = G * d + 8;              // ring row stride: no bank conflicts
  const int slot_floats = kKs * ws;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int quads = d / 4;
  const int c0 = warp_col0();
  const int steps = K / kKs;
  auto stage = [&](int s) {
    if (s < steps) {
      float* dst = ring + (s % kRingSlots) * slot_floats;
      const int k0 = s * kKs;
#pragma unroll
      for (int g = 0; g < G; ++g)
        for (int i = tid; i < kKs * quads; i += nthreads) {
          const int r = i / quads, q = i - r * quads;
          cp_async16(dst + r * ws + g * d + 4 * q,
                     w[g] + (long long)(k0 + r) * ldw + 4 * q, true);
        }
    }
    cp_async_commit();
  };
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kRingSlots - 1; ++s) stage(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRingSlots - 2>();
    __syncthreads();
    stage(s + kRingSlots - 1);
    const float* bs = ring + (s % kRingSlots) * slot_floats;
    FragA fa[kMTiles];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
      fa[mt] = frag_a_rows(a, lda, mt * 16, s * kKs);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const FragB fb = frag_b<false>(bs, ws, 0, g * d + c0 + nt * 8);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
          mma3(acc[slot[g]][mt][nt], fa[mt], fb);
      }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int NA>
__device__ __forceinline__ void zero_acc(float (&acc)[NA][kMTiles][2][4]) {
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][mt][nt][i] = 0.f;
}

#endif  // !TK_BF16

// The columns of a tensor-core tile's block at a time: 16 a warp, so all d
// with the backward tiles' d / 16 warps, a slab with fewer (K2f).
__device__ __forceinline__ int block_cols() { return blockDim.x / 2; }

#if !TK_BF16

// The conv output of a tile of kBwdRows rows (a0.. of element b; its input
// rows loaded in xs) into cs (row stride ld): the SpMM rows, then + (xs @
// loop) * mask through tile_product, block_cols() columns at a time, then
// the ReLU when p.relu. Writes norm^2 of each row to n2_out when it is not
// null. Each column slab's epilogue writes the thread's own accumulator
// positions of cs, so with one slab a thread may read its own positions
// back without a barrier; the next tile_product's opening barrier
// publishes the rest.
__device__ __forceinline__ void conv_rows_tc(const Layer& p, int b, int a0,
                                             const float* xs, float* cs,
                                             int ld, float* ring,
                                             float* n2_out) {
  const int d = p.d, A = p.A, w = block_cols(), c0 = warp_col0();
  const long long step_row = ((long long)b * p.L1 + p.k) * A;
  spmm_rows(p, b, a0, kBwdRows, cs, ld, n2_out);
  for (int s0 = 0; s0 < d; s0 += w) {
    float lp[1][kMTiles][2][4];
    zero_acc(lp);
    const float* wl[1] = {p.loopw + s0};
    tile_product<1, 0>(xs, ld, d, wl, d, w, ring, lp);
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(mt, i), c = s0 + c0 + acc_col(nt, i);
          float v = lp[0][mt][nt][i];
          if (p.mask != nullptr && a0 + r < A)
            v *= p.mask[(step_row + a0 + r) * d + c];
          v += cs[r * ld + c];
          cs[r * ld + c] = p.relu ? fmaxf(v, 0.f) : v;
        }
  }
}

// The GRU gate products of a tile at columns s0..s0+block_cols()-1 of each
// gate: acc 0 = gi_r + gh_r, 1 = gi_z + gh_z, 2 = gi_n, 3 = gh_n, without
// the biases, from the GRU input rows cs and the decayed states hs (row
// stride ld, complete at the call) and W_ih, W_hh transposed ([d, 3d]).
// Ends with a barrier.
__device__ __forceinline__ void gate_products(
    const float* cs, const float* hs, int ld, const float* wih_t,
    const float* whh_t, int d, int s0, float* ring,
    float (&acc)[4][kMTiles][2][4]) {
  const int w = block_cols();
  zero_acc(acc);
  const float* wi[3] = {wih_t + s0, wih_t + d + s0, wih_t + 2 * d + s0};
  tile_product<4, 0, 1, 2>(cs, ld, d, wi, 3 * d, w, ring, acc);
  const float* wh[3] = {whh_t + s0, whh_t + d + s0, whh_t + 2 * d + s0};
  tile_product<4, 0, 1, 3>(hs, ld, d, wh, 3 * d, w, ring, acc);
}

#endif  // !TK_BF16

// The gates at an accumulator position of gate_products.
struct GateAt {
  float r, z, n;
  float ghn;  // W_hn h + b_hn, before the reset gate
};

// The GRU biases at the four columns of a thread's accumulator positions
// (column c0 + acc_col(nt, i), by nt and i & 1), read once: b_ir + b_hr,
// b_iz + b_hz, b_in and b_hn.
struct GateBias {
  float r[2][2], z[2][2], in[2][2], hn[2][2];
};

__device__ __forceinline__ GateBias gate_bias(const float* __restrict__ bih,
                                              const float* __restrict__ bhh,
                                              int d, int c0) {
  GateBias gb;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + acc_col(nt, h);
      gb.r[nt][h] = bih[c] + bhh[c];
      gb.z[nt][h] = bih[d + c] + bhh[d + c];
      gb.in[nt][h] = bih[2 * d + c];
      gb.hn[nt][h] = bhh[2 * d + c];
    }
  return gb;
}

// The gates at accumulator position (mt, nt, i) of gate_products, with the
// biases of gate_bias.
__device__ __forceinline__ GateAt gate_at(
    const float (&acc)[4][kMTiles][2][4], int mt, int nt, int i,
    const GateBias& gb) {
  const int h = i & 1;
  GateAt g;
  g.r = sigmoid(acc[0][mt][nt][i] + gb.r[nt][h]);
  g.z = sigmoid(acc[1][mt][nt][i] + gb.z[nt][h]);
  g.ghn = acc[3][mt][nt][i] + gb.hn[nt][h];
  g.n = tanhf((acc[2][mt][nt][i] + gb.in[nt][h]) + g.r * g.ghn);
  return g;
}

// The warps of a forward tile's block, at most max_warps: each owns 16
// columns of the block's slab of every gate, so a slab of 16 * warps
// columns, and d / (16 * warps) slabs a tile (fewer warps where d / 16 is
// not a multiple of max_warps).
__host__ __device__ constexpr int fwd_warps(int d, int max_warps) {
  int w = max_warps < d / 16 ? max_warps : d / 16;
  while ((d / 16) % w != 0) --w;
  return w;
}

// The float32 forward and backward tiles (the bfloat16 mode's are
// window_bf16.cuh's native ones).
#if !TK_BF16

// Shared memory of fwd_layer_tile in floats: the ring of three gate windows
// of the slab, then xs, cs and hs ([kBwdRows, d + 4] each).
__host__ __device__ constexpr int fwd_layer_smem_floats(int d, int warps) {
  return ring_floats(3, 16 * warps) + 3 * kBwdRows * (d + 4);
}

// The forward of one RGCN+GRU layer of step p.k for the kBwdRows rows
// a0.. of element b, at the block_cols() columns s0.. of every gate: the
// rows, the conv output (conv_rows_tc, unless p.conv_given) and the gate
// products (gate_products) into the accumulators; then out(row, c, h,
// conv) at each of the thread's accumulator positions inside the layer,
// with row the row's index in [B, L1, A], c the column, h the GRU's output
// (1 - z) n + z h_prev and conv the conv output there.
template <typename Out>
__device__ __forceinline__ void fwd_layer_tile(const Layer& p, int b, int a0,
                                               int s0, Out&& out) {
  extern __shared__ float smem[];
  const int d = p.d, A = p.A, ld = d + 4;
  float* ring = smem;
  float* xs = ring + ring_floats(3, block_cols());
  float* cs = xs + kBwdRows * ld;      // conv output (xs when given)
  float* hs = cs + kBwdRows * ld;      // decayed previous states
  const int c0 = warp_col0();
  const long long step_row = ((long long)b * p.L1 + p.k) * A;
  load_tile(p, b, a0, kBwdRows, ld, xs, cs, hs);
  if (!p.conv_given) conv_rows_tc(p, b, a0, xs, cs, ld, ring, nullptr);
  float acc[4][kMTiles][2][4];
  gate_products(cs, hs, ld, p.wih_t, p.whh_t, d, s0, ring, acc);
  const GateBias gb = gate_bias(p.bih, p.bhh, d, s0 + c0);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = s0 + c0 + acc_col(nt, i);
        if (a0 + r >= A) continue;
        const GateAt g = gate_at(acc, mt, nt, i, gb);
        out(step_row + a0 + r, c, (1.f - g.z) * g.n + g.z * hs[r * ld + c],
            cs[r * ld + c]);
      }
}

// Shared memory of bwd_gru_tile in floats: the ring of three gate windows,
// then the tile region: xs, cs, hs ([kBwdRows, d + 4] each), later dg
// ([kBwdRows, 4d + 4], the larger) over them. 103,680 bytes at d = 128:
// two blocks an SM.
__host__ __device__ constexpr int bwd_gru_smem_floats(int d) {
  return ring_floats(3, d) + kBwdRows * (4 * d + 4);
}

// Backward of one layer's GRU at step k for a tile of kBwdRows rows
// (blockIdx.x) of element blockIdx.y, with d / 16 warps: recomputes the
// conv output and the gates (conv_rows_tc, gate_products: K2f's products),
// takes d_out from db, and gives d_conv (plus
// the cotangent g_loc of the conv output itself when it is not null, both
// through the ReLU's mask when p.relu; and d_conv * mask, the self-loop
// cotangent) into the step scratch, the gate cotangents and their product
// operands into the step scratch for the weight launch. The cotangent of
// each row's previous state goes to dprev at the row itself when dprev is
// not null (the final step: d_hist), else it is added into db at the row
// gidx names (the window; dead rows add nothing). Its five products (the
// self-loop, the input and hidden gate products, d_gi @ W_ih and
// d_gh @ W_hh) go through tile_product; each thread keeps the gates of its
// accumulator positions in registers between them.
__device__ __forceinline__ void bwd_gru_tile(
    const Layer& p,
    const float* __restrict__ wih,     // [3d, d] (torch layout)
    const float* __restrict__ whh,     // [3d, d]
    float* db,                         // [B, L1, A, d]
    const float* __restrict__ g_loc,   // [B, L1, A, d] or null
    float* __restrict__ dprev,         // [B, L1, A, d] or null
    float* n2_out,                     // [B, L1, A] or null
    float* __restrict__ conv_s,        // [B*A, d]   step scratch
    float* __restrict__ h0g_s,         // [B*A, d]
    float* __restrict__ dgi_s,         // [B*A, 3d]
    float* __restrict__ dgh_s,         // [B*A, 3d]
    float* __restrict__ dconv_s,       // [B*A, d]
    float* __restrict__ dlp_s) {       // [B*A, d]
  extern __shared__ float smem[];
  const int d = p.d, A = p.A, d3 = 3 * d;
  const int ld = d + 4, ldg = 4 * d + 4;
  float* ring = smem;
  float* xs = smem + ring_floats(3, d);
  float* cs = xs + kBwdRows * ld;
  float* hs = cs + kBwdRows * ld;
  float* dg = xs;                      // [kBwdRows, 4d]: d_r, d_z, d_n, d_ghn
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kBwdRows;
  const int c0 = warp_col0();
  const long long elem_row = (long long)b * p.L1 * A;
  const long long step_row = elem_row + (long long)p.k * A;

  load_tile(p, b, a0, kBwdRows, ld, xs, nullptr, hs);
  conv_rows_tc(p, b, a0, xs, cs, ld, ring, n2_out);
  float acc[4][kMTiles][2][4];
  gate_products(cs, hs, ld, p.wih_t, p.whh_t, d, 0, ring, acc);
  const GateBias gb = gate_bias(p.bih, p.bhh, d, c0);
  // the gate cotangents, in place of the gates; d_out * z
  float dh_direct[kMTiles][2][4];
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
        float pr = 0.f, pz = 0.f, pn = 0.f, phn = 0.f, dhd = 0.f;
        if (a < A) {
          const long long row = step_row + a;
          const long long m = (long long)b * A + a;
          const GateAt g = gate_at(acc, mt, nt, i, gb);
          const float rg = g.r, z = g.z, n = g.n, ghn = g.ghn;
          const float dout = db[row * d + c];
          const float h = hs[r * ld + c];
          const float dz = dout * (h - n);
          const float dn = dout * (1.f - z);
          dhd = dout * z;
          pn = dn * (1.f - n * n);
          phn = pn * rg;
          pr = pn * ghn * rg * (1.f - rg);
          pz = dz * z * (1.f - z);
          conv_s[m * d + c] = cv;
          h0g_s[m * d + c] = h;
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
  __syncthreads();                     // dg overwrites xs, cs and hs
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dg[acc_row(mt, i) * ldg + j * d + c0 + acc_col(nt, i)] =
              acc[j][mt][nt][i];

  // d_conv = d_gi @ W_ih (acc 0), d_h0g += d_gh @ W_hh (acc 1), a gate
  // section of the depth at a time
  float dx[2][kMTiles][2][4];
  zero_acc(dx);
  {
    const long long dd = (long long)d * d;
    const float* wr[2] = {wih, whh};
    tile_product<2, 0, 1>(dg, ldg, d, wr, d, d, ring, dx);
    const float* wz[2] = {wih + dd, whh + dd};
    tile_product<2, 0, 1>(dg + d, ldg, d, wz, d, d, ring, dx);
    const float* wn[1] = {wih + 2 * dd};
    tile_product<2, 0>(dg + 2 * d, ldg, d, wn, d, d, ring, dx);
    const float* wh[1] = {whh + 2 * dd};
    tile_product<2, 1>(dg + 3 * d, ldg, d, wh, d, d, ring, dx);
  }
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = a0 + acc_row(mt, i), c = c0 + acc_col(nt, i);
        if (a >= A) continue;
        const long long row = step_row + a;
        const long long m = (long long)b * A + a;
        float dc = dx[0][mt][nt][i];
        if (g_loc != nullptr) dc += g_loc[row * d + c];
        if (p.relu && !((pos_bits >> ((mt * 2 + nt) * 4 + i)) & 1u)) dc = 0.f;
        dconv_s[m * d + c] = dc;
        dlp_s[m * d + c] = p.mask != nullptr ? dc * p.mask[row * d + c] : dc;
        const float lv = live_of(p, row);
        const float dec = expf(-p.lam * p.dt[row]);
        const float dh = dh_direct[mt][nt][i] + dx[1][mt][nt][i];
        if (dprev != nullptr) {
          dprev[row * d + c] = dh * dec * lv;
        } else if (lv != 0.f) {
          db[prev_row(p, elem_row, row) * d + c] += dh * dec * lv;
        }
      }
}

// Shared memory of bwd_input_tile in floats: the ring of one window, then
// ls and cs ([kBwdRows, d + 4] each).
__host__ __device__ constexpr int bwd_input_smem_floats(int d) {
  return ring_floats(1, d) + 2 * kBwdRows * (d + 4);
}

// Cotangent of one layer's input rows at step k, for a tile of kBwdRows
// rows (blockIdx.x) of element blockIdx.y, with d / 16 warps: out = (base +
// SpMM^T of d_conv) + d_lp @ loop^T, with base the current out (accumulate)
// or 0; the product through tile_product. Also writes each edge's
// relation-weight cotangent (over a CSR by source, so every unmasked edge
// of the step is written once; masked edges are in no CSR and their slots
// are never read).
__device__ __forceinline__ void bwd_input_tile(
    const int* __restrict__ s_ptr,     // [B*L1*A + 1] CSR by (b, k, src)
    const int* __restrict__ s_dst,     // step-local destination rows
    const int* __restrict__ s_rel,
    const float* __restrict__ s_em,
    const int* __restrict__ s_eid,     // the edge's index in [B*L1*E]
    const float* __restrict__ n2,      // [B, L1, A]
    const float* __restrict__ dconv_s, // [B*A, d]
    const float* __restrict__ dlp_s,   // [B*A, d]
    const float* __restrict__ wrel, int wstride, int wcol,
    const float* __restrict__ loop_t,  // [d, d], the self-loop transposed
    const float* __restrict__ x,       // [B, L1, A, d] the layer's input
    float* __restrict__ ewg,           // [B*L1*E, d]
    float* out,                        // [B, L1, A, d]
    int accumulate, int L1, int A, int d, int k) {
  extern __shared__ float smem[];
  const int ld = d + 4;
  float* ring = smem;
  float* ls = smem + ring_floats(1, d);  // [kBwdRows, d] d_lp rows
  float* cs = ls + kBwdRows * ld;        // [kBwdRows, d] SpMM^T rows
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kBwdRows;
  const long long step_row = ((long long)b * L1 + k) * A;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int i = tid; i < kBwdRows * d; i += nthreads) {
    const int r = i / d, c = i - r * d;
    const int a = a0 + r;
    ls[r * ld + c] = a < A ? dlp_s[((long long)b * A + a) * d + c] : 0.f;
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
      const float* xr = x + row * d;
      const int e1 = s_ptr[row + 1];
      for (int e = s_ptr[row]; e < e1; ++e) {
        const int t = s_dst[e];
        const float s = n2[step_row + t] * s_em[e];
        const float* gt = dconv_s + ((long long)b * A + t) * d;
        const float* wr = wrel + (long long)s_rel[e] * wstride + wcol;
        float* er = ewg + (long long)s_eid[e] * d;
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {
          const int c = lane + j * kWarp;
          if (c < d) {
            const float gv = gt[c] * s;
            acc[j] += gv * wr[c];
            er[c] = gv * xr[c];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) cs[r * ld + c] = acc[j];
    }
  }

  float lp[1][kMTiles][2][4];
  zero_acc(lp);
  const float* w[1] = {loop_t};
  tile_product<1, 0>(ls, ld, d, w, d, d, ring, lp);
  const int c0 = warp_col0();
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(mt, i), c = c0 + acc_col(nt, i), a = a0 + r;
        if (a >= A) continue;
        float* o = out + (step_row + a) * d + c;
        const float base = accumulate ? *o : 0.f;
        *o = (base + cs[r * ld + c]) + lp[0][mt][nt][i];
      }
}

#endif  // !TK_BF16

// Weight cotangents: out[x_col, g_col] += sum over B*A rows of
// X[row, x_col] * G[row, g_col], and bias[g_col] += sum of G (X's column of
// ones), as a product whose depth is the rows. The rows are cut into ranges
// (blockIdx.y); each range adds into its own copy of the outputs (part +
// range * part_stride), so no two blocks write one address, and a
// reduction sums the copies in range order: deterministic sums.
// blockIdx.x walks the output tiles of up to kWgJobs jobs: kWgM x columns
// by kWgN g columns, four warps of 32 x 32. The X and G rows of a range
// stream through a ring of kWgSlots slots of kWgK rows (cp.async), the
// products in 3xTF32 as the tiles'. The bias is the column sums of the
// staged G rows, taken in row order by the first x tile's blocks (the ones
// column of X, without a tile of its own).
constexpr int kWgM = 64;      // x columns per tile
constexpr int kWgN = 64;      // g columns per tile
constexpr int kWgK = 32;      // rows per ring slot
constexpr int kWgSlots = 3;
constexpr int kWgLd = kWgM + 8;  // slot row stride (kWgM == kWgN)
constexpr int kWgThreads = 128;
constexpr int kWgJobs = 6;
constexpr int kNoJob = 0x7fffffff;  // `first` of an unused job slot
constexpr int kWgSmemBytes = kWgSlots * 2 * kWgK * kWgLd * sizeof(float);

#if !TK_BF16
struct WJob {
  const float* x;      // row (b, a) at x + b * x_es + a * nx
  long long x_es;
  const float* g;      // row (b, a) at g + b * g_es + a * ng
  long long g_es;
  float* out;          // [nx, ng] in range 0's copy
  float* bias;         // [ng] or null
  int nx, ng, tiles_g, first;
};

struct WJobs {
  WJob job[kWgJobs];
};

__device__ __forceinline__ void wgrad_tile(const WJobs& jobs, int B, int A,
                                           int rows_per_split,
                                           long long part_stride) {
  extern __shared__ float smem[];
  int j = 0;
  while (j + 1 < kWgJobs && (int)blockIdx.x >= jobs.job[j + 1].first) ++j;
  const WJob jb = jobs.job[j];
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
  constexpr int kSlot = 2 * kWgK * kWgLd;    // X rows, then G rows
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float bsum = 0.f;

  auto stage = [&](int s) {
    if (s < steps) {
      float* xs = smem + (s % kWgSlots) * kSlot;
      float* gs = xs + kWgK * kWgLd;
      const int m0 = m_begin + s * kWgK;
      for (int i = tid; i < kWgK * (kWgM / 4); i += kWgThreads) {
        const int r = i / (kWgM / 4), q = i % (kWgM / 4);
        const int m = m0 + r;
        const int b = m / A, a = m - b * A;
        const int xc = tx0 + 4 * q, gc = tg0 + 4 * q;
        const bool xv = m < m_end && xc < jb.nx;
        const bool gv = m < m_end && gc < jb.ng;
        cp_async16(xs + r * kWgLd + 4 * q,
                   xv ? jb.x + b * jb.x_es + (long long)a * jb.nx + xc : jb.g,
                   xv);
        cp_async16(gs + r * kWgLd + 4 * q,
                   gv ? jb.g + b * jb.g_es + (long long)a * jb.ng + gc : jb.g,
                   gv);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kWgSlots - 1; ++s) stage(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWgSlots - 2>();
    __syncthreads();
    stage(s + kWgSlots - 1);
    const float* xs = smem + (s % kWgSlots) * kSlot;
    const float* gs = xs + kWgK * kWgLd;
    if (x_rows) {
#pragma unroll
      for (int k0 = 0; k0 < kWgK; k0 += 8) {
        FragA fa[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          fa[mt] = frag_a_depth(xs, kWgLd, wm + mt * 16, k0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const FragB fb = frag_b<true>(gs, kWgLd, k0, wn + nt * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], fa[mt], fb);
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

#endif  // !TK_BF16

// out[i] = sum over the ranges s = 0..n_split-1 of part[s][i], in order.
__device__ __forceinline__ void wgrad_reduce_one(
    const float* __restrict__ part, int n_split, long long total,
    float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += part[s * total + i];
  out[i] = acc;
}

// Rows per range of a weight launch over M rows cut into n_split ranges.
inline int wgrad_rows_per_split(int M, int n_split) {
  const int per = (M + n_split - 1) / n_split;
  return (per + kWgK - 1) / kWgK * kWgK;
}

#if !TK_BF16
// A weight launch: `tiles` output tiles (make_job's count) by n_split
// ranges of the B*A rows.
template <typename K>
cudaError_t launch_wgrad(K kernel, const WJobs& jobs, int tiles, int n_split,
                         int B, int A, long long total, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, n_split), kWgThreads, kWgSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      jobs, B, A, wgrad_rows_per_split(B * A, n_split), total);
  return cudaGetLastError();
}

// A whole-width tile launch (the backward tiles, or the flagship's forward
// bi_layer_kernel, in `kernel`) over (row tile, element), d / 16 warps,
// `floats` of shared memory.
template <typename K, typename... Args>
cudaError_t launch_bwd_tile(K kernel, int floats, int B, int A, int d,
                            void* stream, Args... args) {
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((A + kBwdRows - 1) / kBwdRows, B);
  kernel<<<grid, 2 * d, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

#endif  // !TK_BF16

Layer make_layer(const void* x, int conv_given, const void* rowptr,
                 const void* src, const void* rel, const void* em,
                 const void* wrel, int wstride, int wcol, const void* loopw,
                 const void* mask, int relu, const void* wih_t,
                 const void* whh_t,
                 const void* bih, const void* bhh, const void* gidx,
                 const void* live, const void* dt, float lam,
                 const void* prev, int L1, int A, int d, int k,
                 int x_bf16 = 0) {
  Layer p;
  p.x = static_cast<const float*>(x);
  p.conv_given = conv_given;
  p.rowptr = static_cast<const int*>(rowptr);
  p.src = static_cast<const int*>(src);
  p.rel = static_cast<const int*>(rel);
  p.em = static_cast<const float*>(em);
  p.wrel = static_cast<const float*>(wrel);
  p.wstride = wstride;
  p.wcol = wcol;
  p.loopw = static_cast<const float*>(loopw);
  p.mask = static_cast<const float*>(mask);
  p.relu = relu;
  p.wih_t = static_cast<const float*>(wih_t);
  p.whh_t = static_cast<const float*>(whh_t);
  p.bih = static_cast<const float*>(bih);
  p.bhh = static_cast<const float*>(bhh);
  p.gidx = static_cast<const int*>(gidx);
  p.live = static_cast<const float*>(live);
  p.dt = static_cast<const float*>(dt);
  p.lam = lam;
  p.prev = static_cast<const float*>(prev);
  p.L1 = L1;
  p.A = A;
  p.d = d;
  p.k = k;
  p.x_bf16 = x_bf16;
  return p;
}

#if !TK_BF16
WJob make_job(const void* x, long long x_es, const void* g, long long g_es,
              float* out, float* bias, int nx, int ng, int* first) {
  WJob jb;
  jb.x = static_cast<const float*>(x);
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

#endif  // !TK_BF16

// The relation-weight cotangent, summed per relation without atomics:
// out[r, :d] = the rows of v1 of relation r's edges, in the order of a CSR
// by relation (r_ptr, and r_eid each edge's row of v1), and, when v2 is
// given, out[r, d:2d] the same of v2 (out then has rows of 2d). One warp a
// relation. The window backward (both layers at once) and the final step's
// loss and layer backwards launch it.
constexpr int kRelWarps = 8;

__global__ void rel_sum_kernel(const int* __restrict__ r_ptr,
                               const int* __restrict__ r_eid,
                               const float* __restrict__ v1,
                               const float* __restrict__ v2,
                               float* __restrict__ out, int n_rels, int d) {
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRelWarps + threadIdx.x / kWarp;
  if (r >= n_rels) return;
  const bool two = v2 != nullptr;
  float a1[kMaxChunks], a2[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) a1[j] = a2[j] = 0.f;
  const int e1 = r_ptr[r + 1];
  for (int e = r_ptr[r]; e < e1; ++e) {
    const long long base = (long long)r_eid[e] * d;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) {
        a1[j] += v1[base + c];
        if (two) a2[j] += v2[base + c];
      }
    }
  }
  float* o = out + (long long)r * (two ? 2 : 1) * d;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = lane + j * kWarp;
    if (c < d) {
      o[c] = a1[j];
      if (two) o[d + c] = a2[j];
    }
  }
}

cudaError_t rel_sum(const void* r_ptr, const void* r_eid, const void* v1,
                    const void* v2, void* out, int n_rels, int d,
                    void* stream) {
  if (n_rels > 0)
    rel_sum_kernel<<<(n_rels + kRelWarps - 1) / kRelWarps, kRelWarps * kWarp,
                     0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(r_ptr), static_cast<const int*>(r_eid),
        static_cast<const float*>(v1), static_cast<const float*>(v2),
        static_cast<float*>(out), n_rels, d);
  return cudaGetLastError();
}

}  // namespace
