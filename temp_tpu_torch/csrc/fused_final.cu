// The dense final step and the exact-softmax loss of GRRGCN training, for a
// batch of B target snapshots: forward (K3), loss backward (K4) and layer
// backward (K5); and the fused filtered eval of B snapshots (K11).
//
// K3 replaces the TPU kernel temp_tpu/ops/fused_final.py:_fwd_kernel, which
// runs one batch element as one program: layer 1 (relational SpMM with the
// double degree norm over the encoder's 50% edge subsample, the self-loop
// product times its dropout mask, a GRU from the history decayed by
// exp(-lambda * dt)) and layer 2 over all N entity rows, the optional
// use_embed_for_non_active select, the ComplEx query of each edge slot in
// both directions, its scores against every entity with the other true
// answers at -1e9, and the exact-softmax cross-entropy averaged over the
// positives. Here: final_layer_kernel twice (the window's forward tile,
// rgcn_gru_layer.cuh fwd_layer_tile, with one step of all N rows and the
// dense history as previous state), final_scores_kernel (for a tile of 64
// queries, one direction and one of 8 ranges of entity columns: the
// queries, then the column tiles with the masked columns skipped and a
// running max and sum of exponentials, written as partials) and
// final_loss_reduce_kernel (per element: the partials and the positive's
// score into each query's log-sum-exp, then the loss).
//
// K4 replaces _bwd_loss_kernel: from the saved table, the queries and their
// log-sum-exps, final_dq_kernel gives each query's sum over one column range
// of p * table row (p = its softmax weight), final_dq_finish_kernel sums the
// ranges and takes each edge's query cotangent back to its subject, object
// and relation rows, final_dtable_kernel gives each table row the sum over
// all queries of w * p * qhat plus the rows of the edges whose subject or
// object it is, and the window's relation sum (rgcn_gru_layer.cuh) sums
// the relation rows per relation over a CSR by relation. The scores are
// recomputed (twice) rather than stored: [B, 2, E, N] would be 117 MB at
// icews14 width.
//
// K5 replaces _bwd_layer_kernel, the backward of one encoder layer: the
// window backward's launches for one step (rgcn_gru_layer.cuh) with L1 = 1,
// the previous-state cotangent written to d_hist (not added into an
// earlier row) and the input cotangent to the layer's input: the GRU
// recompute and backward (32-row tiles), the input cotangent with per-edge
// relation cotangents, the weight cotangents over B*N rows in 16 ranges,
// their sum, and the relation sum. Its products (42 d^2 flops a row) run
// on the tensor cores in 3xTF32 at f32 accuracy (tile_product and
// wgrad_tile), with the weights streamed through shared memory.

// K11 replaces _eval_kernel, the forward-only eval of one element: the
// final encoder in eval mode (no dropout, the full edge mask), the ComplEx
// query of each eval query slot in both directions, its scores against
// every entity with the other true answers (the total filter table: the
// facts of all splits at t) at -1e7, the filtered rank as 1 + the count of
// strictly greater scores, and the BCE of the positives. Here: K3's
// final_layer_kernel twice, then final_ranks_kernel (shaped like
// final_scores_kernel: for a tile of 64 query slots, one direction and one
// of 8 ranges of entity columns, a count per slot instead of a running
// max and sum) and final_rank_reduce_kernel (per element: the counts into
// ranks, and the BCE). Nothing but the ranks and the BCE leaves the card:
// the [B, 2, Q, N] scores are never stored.
//
// What bounds all four on an H100: f32 arithmetic. Per element K3 does
// four [N, d] x [d, 3d] GRU products, two [N, d] x [d, d] self-loop products
// and two [E, d] x [d, N] score products; K4 four score-sized products; K5
// per layer about three times the layer's forward; K11 K3's layers and two
// [Q, d] x [d, N] score products. The bytes (the history, the tables, the
// weights) are a small fraction of that at d = 128.
//
// What the design does about that. Every launch covers the whole batch (b
// in the grid). The products run on the tensor cores in 3xTF32 at f32
// accuracy (rgcn_gru_layer.cuh), bound by mma.sync's rate: K3's layer
// launches (and K11's) are the window's forward tile in whole-width
// 32-row tiles, so they form the conv output and the gates bit for bit as
// K5's float32 recompute does; K5's tiles are K2b's. K3's scores, both score
// recomputes of K4 and K11's ranks are one routine, score_product: 64
// queries by 64 table rows a block, the queries as A and the table rows,
// staged by cp.async, as B, so every score K4 recomputes equals the one K3
// summed. K11 scores each query's target by the same routine (its rows
// staged as one table tile, the diagonal read), so a column whose row
// equals the target's scores exactly the target's score and does not count
// against it; the target's own column is left out by index. K4's two
// cotangent products, dq = P T and d_table = P^T Q, read the probability
// tile P from shared memory (cot_product). Every sum across blocks goes
// through per-block partials and an ordered second pass, and no kernel
// uses atomics, so runs repeat bit for bit. The true answers come as a
// sorted list per edge or query slot, built once with the data; a block
// turns them into a 64-bit mask per query and column tile.

//
// Compiled a second time as fused_final_bf16.cu, with TK_BF16 1: the
// bfloat16 mode of K3's score and reduce launches and of K4
// (rgcn_gru_layer.cuh), the TPU kernels' bfloat16 instantiation (K3's layer
// launches and K5 are that source's own, on window_bf16.cuh). K3 builds the
// loss's queries from the table's subject and object rows and the relation
// rows split into a high and a low bfloat16 part (hilo_bf16, as the TPU
// kernel gathers them) and scores in bfloat16 (one TF32 product of
// bfloat16-rounded operands a k8 step). The TPU kernel's loss backward
// recomputes the queries from its residual table, stored in bfloat16: so
// K3's score launch scores a second query set (variant 1: the table's rows
// rounded to bfloat16, the relation rows split) beside the loss's (variant
// 0) in the same launch, and its reduce launch gives the loss from variant
// 0 and the log-sum-exps K4 reads from variant 1. K4 weighs the
// probabilities by the loss weight before they are rounded (final_dq takes
// the count and the cotangent), and rounds the row and relation cotangents
// it writes. K3's float32 layer launches, K5 and K11's rank launches are
// left out of this build (K11's layers in bfloat16 are K3's; its ranks
// have no bfloat16 mode).

#include <math.h>

#include "rgcn_gru_layer.cuh"

namespace {

constexpr int kQ = 64;              // queries per block
constexpr int kC = 64;              // entity rows per column tile
constexpr int kLossThreads = 256;   // 8 warps
constexpr int kMaxNt = 8;           // n8 tiles in d / 2 columns, d <= 128
constexpr unsigned kFull = 0xffffffffu;
// Row strides of the probability tile ps of the cotangent products:
// final_dq reads its rows in pairs (8-byte loads, conflict-free at 8 mod
// 32), final_dtable its columns in pairs of rows (conflict-free at 4 mod 32).
constexpr int kLdDq = kC + 8;
constexpr int kLdDt = kC + 4;
// Table tiles of final_scores_kernel in flight: the next tile's copy runs
// under the current tile's products. The cotangent kernels stage one tile
// at a time, so that two of their blocks share an SM (87,808 and 86,784
// bytes at d = 128) and each block's copy runs under the other's products.
constexpr int kScoreBufs = 2;

// Row stride of the query and table tiles of the tensor-core kernels: rows
// of d + 4 floats give the fragment loads of the score product (a row a
// lane group) and of the cotangent products (row pairs) distinct banks.
__host__ __device__ constexpr int tc_ld(int d) { return d + 4; }

// Dynamic shared memory of the loss kernels, in floats: the query masks and
// list cursors, three per-query scalars, the query tile, n_ts table tiles
// (row stride ld) and the probability tile (ps floats).
__host__ __device__ constexpr int loss_smem_floats(int ld, int n_ts,
                                                   int ps) {
  return 2 * kQ + 2 * kQ + 3 * kQ + (kQ + n_ts * kC) * ld + ps;
}

struct LossSmem {
  unsigned long long* mb;   // [kQ] masked columns of the current tile
  int* cur;                 // [kQ] list cursor
  int* end;                 // [kQ] list end
  float* w;                 // [kQ] per-query scalars
  float* l;
  float* f;
  float* qs;                // [kQ][ld]
  float* ts;                // [n_ts][kC][ld]
  float* ps;                // the probability tile
};

__device__ __forceinline__ LossSmem loss_smem(int ld, int n_ts) {
  extern __shared__ float smem[];
  LossSmem s;
  s.mb = reinterpret_cast<unsigned long long*>(smem);
  s.cur = reinterpret_cast<int*>(smem + 2 * kQ);
  s.end = s.cur + kQ;
  s.w = smem + 4 * kQ;
  s.l = s.w + kQ;
  s.f = s.l + kQ;
  s.qs = s.f + kQ;
  s.ts = s.qs + kQ * ld;
  s.ps = s.ts + n_ts * kC * ld;
  return s;
}

// 64 rows of `rows` [*, d] into dst (row stride ld) by cp.async: row r of
// the tile is row at(r) of `rows`, or zeros where at(r) < 0; commits the
// group.
template <typename At>
__device__ __forceinline__ void stage_rows_at(float* dst, int ld,
                                              const float* rows, int d,
                                              At&& at) {
  const int quads = d / 4;
  for (int i = threadIdx.x; i < kC * quads; i += blockDim.x) {
    const int r = i / quads, q = i - r * quads;
    const long long src = at(r);
    cp_async16(dst + r * ld + 4 * q, rows + (src >= 0 ? src : 0) * d + 4 * q,
               src >= 0);
  }
  cp_async_commit();
}

// 64 rows of `rows` from row r0 (row r only where ok(r)).
template <typename Ok>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* rows, long long r0,
                                           int d, Ok&& ok) {
  stage_rows_at(dst, ld, rows, d,
                [&](int r) { return ok(r) ? r0 + r : -1LL; });
}

// -- The tensor-core tiles: the score product and the cotangent products --
//
// The score tile S = Q T^T, 64 queries by 64 table rows at depth d (a
// multiple of 8), from the query tile qs and a table tile ts ([64][ld] each
// in shared memory), on mma.sync m16n8k8 in 3xTF32 with tile_product's rule
// (each operand split into its truncated tf32 part and the rest; each k8
// step's lo*hi + hi*lo + hi*hi from zero, added to the f32 accumulator).
// Warp w holds rows 16 (w / 2).. and columns 32 (w % 2).. of the tile:
// acc[nt][i] at (score_row(i), score_col(nt, i)). K3's scores (and K8's),
// both of K4's recomputes and K11's ranks call it, with the queries as A
// and the table rows as B, so every score K4 recomputes equals bit for bit
// the one K3 summed into the log-sum-exp.
__device__ __forceinline__ int score_row(int i) {
  return ((threadIdx.x / kWarp) >> 1) * 16 + acc_row(0, i);
}

__device__ __forceinline__ int score_col(int nt, int i) {
  return ((threadIdx.x / kWarp) & 1) * 32 + acc_col(nt, i);
}

__device__ __forceinline__ void score_product(const float* qs,
                                              const float* ts, int ld, int d,
                                              float (&acc)[4][4]) {
  const int warp = threadIdx.x / kWarp;
  const int r0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < d; k0 += 8) {
    const FragA fa = frag_a_rows(qs, ld, r0, k0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma3(acc[nt], fa, frag_b_rows(ts, ld, k0, n0 + nt * 8));
  }
}

// The cotangent products over one tile's 64 depth terms, in 3xTF32 with the
// same rule and the depth in the paired order (frag_a_pairs): acc += P R,
// with P the probability tile (its rows the output's 64 rows; kTrans: P^T,
// ps read by columns) and R [64][ld] depth-major (the table tile for d_q,
// the query tile for d_table). Warp w holds rows 16 (w / 2).. and the
// d / 2 columns (w % 2) d / 2.. of the 64 x d output: acc[nt][i] at
// (score_row(i), cot_col(nt, i, d)), nt < d / 16.
__device__ __forceinline__ int cot_col(int nt, int i, int d) {
  return ((threadIdx.x / kWarp) & 1) * (d / 2) + acc_col(nt, i);
}

template <bool kTrans>
__device__ __forceinline__ void cot_product(const float* ps, int ldp,
                                            const float* rs, int ld, int d,
                                            float (&acc)[kMaxNt][4]) {
  const int warp = threadIdx.x / kWarp;
  const int r0 = (warp >> 1) * 16, n0 = (warp & 1) * (d / 2);
  const int nts = d / 16;
#pragma unroll 2
  for (int k0 = 0; k0 < kC; k0 += 8) {
    const FragA fa = kTrans ? frag_a_pairs_t(ps, ldp, r0, k0)
                            : frag_a_pairs(ps, ldp, r0, k0);
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt)
      if (nt < nts) mma3(acc[nt], fa, frag_b_pairs(rs, ld, k0, n0 + nt * 8));
  }
}

template <int NA>
__device__ __forceinline__ void zero_rows(float (&acc)[NA][4]) {
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Each of the block's queries: its list cursor at the first answer >= c_begin
// (inactive queries get an empty list).
__device__ __forceinline__ void init_cursors(LossSmem& s, const int* aptr,
                                             const int* ans, const float* pm,
                                             int e0, int E, int c_begin) {
  const int i = threadIdx.x;
  if (i < kQ) {
    const int e = e0 + i;
    int lo = 0, hi = 0;
    if (e < E && pm[e] > 0.f) {
      lo = aptr[e];
      hi = aptr[e + 1];
      while (lo < hi && ans[lo] < c_begin) ++lo;
    }
    s.cur[i] = lo;
    s.end[i] = hi;
  }
}

// The masks of column tile [c0, c0 + kC), advancing the cursors.
__device__ __forceinline__ void next_masks(LossSmem& s, const int* ans,
                                           int c0) {
  const int i = threadIdx.x;
  if (i < kQ) {
    unsigned long long bits = 0ull;
    int c = s.cur[i];
    const int ce = s.end[i];
    while (c < ce && ans[c] < c0 + kC) {
      bits |= 1ull << (ans[c] - c0);
      ++c;
    }
    s.cur[i] = c;
    s.mb[i] = bits;
  }
}

// Column c < d / 2 of a ComplEx query (re at c, im at c + d / 2) from the
// subject row sr, the object row orow and the relation row r: the tail
// query s * r (dir 0) or the head query conj(r) * o. K3's scores and K11's
// ranks build their query tiles with it.
__device__ __forceinline__ void complex_query(int dir, const float* sr,
                                              const float* orow,
                                              const float* r, int c, int d2,
                                              float& re, float& im) {
  if (dir == 0) {
    re = sr[c] * r[c] - sr[c + d2] * r[c + d2];
    im = sr[c] * r[c + d2] + sr[c + d2] * r[c];
  } else {
    re = r[c] * orow[c] + r[c + d2] * orow[c + d2];
    im = r[c] * orow[c + d2] - r[c + d2] * orow[c];
  }
}

// (m, s) += (m2, s2): two running maxima and sums of exp(x - m) as one (an
// empty one has m = -inf and s = 0).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mn))
      + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mn));
  m = mn;
}

// -- K3 ----------------------------------------------------------------------

// K3's layer launches in float32 (fused_final_bf16.cu has the bfloat16
// mode's own, on window_bf16.cuh).
#if !TK_BF16

// K3's layer block: at most kFinalWarps warps of 16 columns each, so one
// slab of all d = 128 columns a 32-row tile: 1,784 blocks of 256 threads a
// launch at the main shape (B = 8, N = 7,128), 88,320 bytes, two an SM.
// The final step's 57,024 rows give blocks enough for whole-width tiles,
// which do not redo the SpMM and the self-loop a slab: 0.88 ms a step for
// both layers where two slabs of 64 columns (four warps, three blocks an
// SM) took 1.10 on an H100 (PERF.md).
constexpr int kFinalWarps = 8;

// One encoder layer of the final step for the 32-row tile blockIdx.x /
// slabs of element blockIdx.y at slab blockIdx.x % slabs of every gate
// (fwd_layer_tile: one step of all N rows against the dense history, with
// K2f's and K5's products); layer 2 also applies the select (active[row]
// <= 0 keeps the input row sel_x).
__global__ void __launch_bounds__(kFinalWarps * kWarp, 2) final_layer_kernel(
    Layer p, const float* __restrict__ sel_x, const float* __restrict__ active,
    float* __restrict__ out, int slabs) {
  const int d = p.d;
  const int a0 = (blockIdx.x / slabs) * kBwdRows;
  const int s0 = (blockIdx.x % slabs) * block_cols();
  fwd_layer_tile(p, blockIdx.y, a0, s0,
                 [&](long long row, int c, float h, float) {
                   out[row * d + c] = active != nullptr && active[row] <= 0.f
                                          ? sel_x[row * d + c] : h;
                 });
}

#endif  // !TK_BF16

// Block (query tile, column range) x direction x element. For each of its
// 64 edge slots: the query row (tail: s * r, head: conj(r) * o in ComplEx
// terms) and the positive's score (both written out by range 0's blocks),
// then over the range's column tiles (kScoreBufs in flight) the running
// max m and sum s of exp(score - m) over the columns that are not true
// answers: each thread over its own positions, then merged across the four
// threads of a row and the two warps of its rows, in a fixed order. In the
// bfloat16 mode blockIdx.y is also the variant (2 + direction for variant
// 1), each variant's partials and positive scores in their own half of the
// outputs, the queries written for variant 1.
__global__ void __launch_bounds__(kLossThreads, 2) final_scores_kernel(
    const float* __restrict__ table, const float* __restrict__ rtab,
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ rel, const float* __restrict__ posm,
    const int* __restrict__ t_ptr, const int* __restrict__ t_ans,
    const int* __restrict__ h_ptr, const int* __restrict__ h_ans,
    float* __restrict__ part_m, float* __restrict__ part_s,
    float* __restrict__ qhat_out, float* __restrict__ scpos_out, int N,
    int E, int d, int n_split, int chunk) {
  const int ld = tc_ld(d), d2 = d / 2;
  LossSmem s = loss_smem(ld, kScoreBufs);
  const int n_et = (E + kQ - 1) / kQ;
  const int split = blockIdx.x / n_et;
  const int e0 = (blockIdx.x % n_et) * kQ;
  const int dir = blockIdx.y & 1, b = blockIdx.z;
  const int c_begin = min(N, split * chunk), c_end = min(N, c_begin + chunk);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const float* tb = table + (long long)b * N * d;
  const float* pm = posm + (long long)b * E;
  const int* ans = dir == 0 ? t_ans : h_ans;
  const long long qrow = ((long long)b * 2 + dir) * E;
  // the variant's half of the partials and positive scores, and whether
  // its queries are the ones written out
  const int variant = kBf16 ? blockIdx.y >> 1 : 0;
  const long long B2 = (long long)gridDim.z * 2;
  const long long pvar = variant * B2 * n_split * E, svar = variant * B2 * E;
  const bool write_q = variant == (kBf16 ? 1 : 0);
  auto stage = [&](int c0, int buf) {
    stage_rows(s.ts + buf * kC * ld, ld, tb, c0, d,
               [&](int r) { return c0 + r < c_end; });
  };
#pragma unroll
  for (int i = 0; i < kScoreBufs - 1; ++i) stage(c_begin + i * kC, i);

  for (int i = warp; i < kQ; i += kLossThreads / kWarp) {
    const int e = e0 + i;
    float part = 0.f;
    if (e < E && pm[e] > 0.f) {
      const long long be = (long long)b * E + e;
      const float* sr = tb + (long long)src[be] * d;
      const float* orow = tb + (long long)dst[be] * d;
      const float* r = rtab + (long long)rel[be] * d;
      const float* pos = dir == 0 ? orow : sr;
      for (int c = lane; c < d2; c += kWarp) {
        float re, im;
        if constexpr (kBf16) {
          // the loss's rows split (variant 0), or the rounded table's rows
          // (variant 1); the relation rows split in both
          auto row = [&](float v) {
            return variant ? round_bf16(v) : hilo_bf16(v);
          };
          const float s_re = row(sr[c]), s_im = row(sr[c + d2]);
          const float o_re = row(orow[c]), o_im = row(orow[c + d2]);
          const float r_re = hilo_bf16(r[c]), r_im = hilo_bf16(r[c + d2]);
          if (dir == 0) {
            re = s_re * r_re - s_im * r_im;
            im = s_re * r_im + s_im * r_re;
            part += re * o_re + im * o_im;
          } else {
            re = r_re * o_re + r_im * o_im;
            im = r_re * o_im - r_im * o_re;
            part += re * s_re + im * s_im;
          }
        } else {
          complex_query(dir, sr, orow, r, c, d2, re, im);
          part += re * pos[c] + im * pos[c + d2];
        }
        s.qs[i * ld + c] = re;
        s.qs[i * ld + c + d2] = im;
      }
    } else {
      for (int c = lane; c < d; c += kWarp) s.qs[i * ld + c] = 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (split == 0 && e < E) {
      if (write_q) {
        float* qo = qhat_out + (qrow + e) * d;
        for (int c = lane; c < d; c += kWarp) qo[c] = s.qs[i * ld + c];
      }
      if (lane == 0) scpos_out[svar + qrow + e] = part;
    }
  }
  init_cursors(s, (dir == 0 ? t_ptr : h_ptr) + (long long)b * (E + 1), ans,
               pm, e0, E, c_begin);

  // the thread's two rows (h = 0, 1: score_row(2 h)) over its columns
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int c0 = c_begin, it = 0; c0 < c_end; c0 += kC, ++it) {
    __syncthreads();
    stage(c0 + (kScoreBufs - 1) * kC, (it + kScoreBufs - 1) % kScoreBufs);
    next_masks(s, ans, c0);
    cp_async_wait<kScoreBufs - 1>();
    __syncthreads();
    float acc[4][4];
    score_product(s.qs, s.ts + (it % kScoreBufs) * kC * ld, ld, d, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned long long bits = s.mb[score_row(2 * h)];
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = score_col(nt, 2 * h + j);
          float& v = acc[nt][2 * h + j];
          if (c0 + c >= c_end || ((bits >> c) & 1ull)) v = -INFINITY;
          tmax = fmaxf(tmax, v);
        }
      const float mn = fmaxf(m[h], tmax);
      if (mn == -INFINITY) continue;
      float add = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = acc[nt][2 * h + j];
          add += v == -INFINITY ? 0.f : expf(v - mn);
        }
      sum[h] = (m[h] == -INFINITY ? 0.f : sum[h] * expf(m[h] - mn)) + add;
      m[h] = mn;
    }
  }
  cp_async_wait<0>();
  // the four threads of a row, then the two warps of its rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      lse_merge(m[h], sum[h], __shfl_xor_sync(kFull, m[h], off),
                __shfl_xor_sync(kFull, sum[h], off));
  __syncthreads();
  const bool lead = (lane & 3) == 0;
  if ((warp & 1) && lead) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s.w[score_row(2 * h)] = m[h];
      s.l[score_row(2 * h)] = sum[h];
    }
  }
  __syncthreads();
  if (!(warp & 1) && lead) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = score_row(2 * h), e = e0 + q;
      lse_merge(m[h], sum[h], s.w[q], s.l[q]);
      if (e < E) {
        const long long o =
            pvar + (((long long)b * 2 + dir) * n_split + split) * E + e;
        part_m[o] = m[h];
        part_s[o] = sum[h];
      }
    }
  }
}

// One block per element: each positive query's log-sum-exp over its column
// partials and its positive's score (0 for the other slots), the count of
// positives (at least 1), and the loss: the sum over positives of both
// directions' lse - score, over the count. A fixed tree sums the block. In
// the bfloat16 mode the loss is variant 0's and the log-sum-exps written
// are variant 1's (final_scores_kernel).
__global__ void final_loss_reduce_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ scpos, const float* __restrict__ posm,
    float* __restrict__ lse, float* __restrict__ cnt,
    float* __restrict__ loss, int E, int n_split) {
  __shared__ float red_ce[kLossThreads], red_n[kLossThreads];
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long B2 = (long long)gridDim.x * 2;
  float ce = 0.f, n = 0.f;
  for (int e = tid; e < E; e += kLossThreads) {
    const float pm = posm[(long long)b * E + e];
    n += pm;
    for (int dir = 0; dir < 2; ++dir) {
      const long long q = ((long long)b * 2 + dir) * E + e;
      float l = 0.f;
      for (int v = 0; v < (kBf16 ? 2 : 1); ++v) {
        l = 0.f;
        if (pm > 0.f) {
          const float sp = scpos[v * B2 * E + q];
          const long long base =
              v * B2 * n_split * E + ((long long)b * 2 + dir) * n_split * E
              + e;
          float mx = sp;
          for (int sp_i = 0; sp_i < n_split; ++sp_i)
            mx = fmaxf(mx, part_m[base + (long long)sp_i * E]);
          float sum = expf(sp - mx);
          for (int sp_i = 0; sp_i < n_split; ++sp_i) {
            const float pmx = part_m[base + (long long)sp_i * E];
            if (pmx != -INFINITY)
              sum += part_s[base + (long long)sp_i * E] * expf(pmx - mx);
          }
          l = mx + logf(sum);
          if (v == 0) ce += pm * (l - sp);
        }
      }
      lse[q] = l;
    }
  }
  red_ce[tid] = ce;
  red_n[tid] = n;
  __syncthreads();
  for (int w = kLossThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_ce[tid] += red_ce[tid + w];
      red_n[tid] += red_n[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float c = fmaxf(red_n[0], 1.f);
    cnt[b] = c;
    loss[b] = red_ce[0] / c;
  }
}

// -- K4 ----------------------------------------------------------------------

// Block (query tile, column range) x direction x element: for each positive
// query q, the sum over the range's columns n of p_qn * table[n], with
// p_qn = exp(score - lse_q) (0 at true answers); unscaled by the loss
// weight, one partial per range. A column tile: its scores (score_product,
// K3's), then p into ps, then dq += P T (cot_product). The bfloat16 mode
// scales p by the query's loss weight posm * g / count first (cnt, gout),
// as the TPU kernel rounds the weighted probabilities.
__global__ void __launch_bounds__(kLossThreads, 2) final_dq_kernel(
    const float* __restrict__ table, const float* __restrict__ qhat,
    const float* __restrict__ lse, const float* __restrict__ posm,
    const int* __restrict__ t_ptr, const int* __restrict__ t_ans,
    const int* __restrict__ h_ptr, const int* __restrict__ h_ans,
    const float* __restrict__ cnt, const float* __restrict__ gout,
    float* __restrict__ part_dq, int N, int E, int d, int n_split,
    int chunk) {
  const int ld = tc_ld(d);
  LossSmem s = loss_smem(ld, 1);
  const int n_et = (E + kQ - 1) / kQ;
  const int split = blockIdx.x / n_et;
  const int e0 = (blockIdx.x % n_et) * kQ;
  const int dir = blockIdx.y, b = blockIdx.z;
  const int c_begin = min(N, split * chunk), c_end = min(N, c_begin + chunk);
  const int tid = threadIdx.x;
  const float* tb = table + (long long)b * N * d;
  const float* pm = posm + (long long)b * E;
  const int* ans = dir == 0 ? t_ans : h_ans;
  const long long qrow = ((long long)b * 2 + dir) * E;

  stage_rows(s.qs, ld, qhat, qrow + e0, d, [&](int r) {
    return e0 + r < E && pm[e0 + r] > 0.f;
  });
  if (tid < kQ) {
    const int e = e0 + tid;
    const bool on = e < E && pm[e] > 0.f;
    s.f[tid] = on ? 1.f : 0.f;
    if constexpr (kBf16) s.w[tid] = on ? pm[e] * (gout[b] / cnt[b]) : 0.f;
    s.l[tid] = on ? lse[qrow + e] : 0.f;
  }
  init_cursors(s, (dir == 0 ? t_ptr : h_ptr) + (long long)b * (E + 1), ans,
               pm, e0, E, c_begin);

  float dq[kMaxNt][4];
  zero_rows(dq);
  for (int c0 = c_begin; c0 < c_end; c0 += kC) {
    __syncthreads();
    stage_rows(s.ts, ld, tb, c0, d, [&](int r) { return c0 + r < c_end; });
    next_masks(s, ans, c0);
    cp_async_wait<0>();
    __syncthreads();
    float acc[4][4];
    score_product(s.qs, s.ts, ld, d, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = score_row(2 * h);
      const unsigned long long bits = s.mb[q];
      const bool on = s.f[q] > 0.f;
      const float l = s.l[q];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float p[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = score_col(nt, 2 * h + j);
          const bool ok = on && c0 + c < c_end && !((bits >> c) & 1ull);
          p[j] = ok ? expf(acc[nt][2 * h + j] - l) : 0.f;
          if constexpr (kBf16) p[j] *= s.w[q];
        }
        *reinterpret_cast<float2*>(s.ps + q * kLdDq + score_col(nt, 2 * h)) =
            make_float2(p[0], p[1]);
      }
    }
    __syncthreads();
    cot_product<false>(s.ps, kLdDq, s.ts, ld, d, dq);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nt = 0; nt < kMaxNt; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + score_row(i);
      if (nt >= d / 16 || e >= E) continue;
      part_dq[((((long long)b * 2 + dir) * n_split + split) * E + e) * d
              + cot_col(nt, i, d)] = dq[nt][i];
    }
}

// One warp per edge slot: w = posm * g / count; per direction the query
// cotangent w * (sum of the range partials) + w * (p_pos - 1) * positive
// row, taken back through the ComplEx query to the subject, object and
// relation rows (zeros for slots that are not positives). In the bfloat16
// mode the partials are weighted already, the subject and object rows are
// the table's rounded to bfloat16 and the relation rows split (as the
// queries K4 reads were built), and the three cotangents are written
// rounded to bfloat16, as the TPU kernel casts them before its scatters.
__global__ void final_dq_finish_kernel(
    const float* __restrict__ table, const float* __restrict__ rtab,
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ rel, const float* __restrict__ posm,
    const float* __restrict__ qhat, const float* __restrict__ scpos,
    const float* __restrict__ lse, const float* __restrict__ cnt,
    const float* __restrict__ gout, const float* __restrict__ part_dq,
    float* __restrict__ d_s, float* __restrict__ d_o,
    float* __restrict__ d_remb, int N, int E, int d, int n_split) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int e = blockIdx.x * (blockDim.x / kWarp) + warp;
  const int b = blockIdx.y;
  if (e >= E) return;
  const long long be = (long long)b * E + e;
  float* ds_row = d_s + be * d;
  float* do_row = d_o + be * d;
  float* dr_row = d_remb + be * d;
  const float pm = posm[be];
  if (!(pm > 0.f)) {
    for (int c = lane; c < d; c += kWarp)
      ds_row[c] = do_row[c] = dr_row[c] = 0.f;
    return;
  }
  const int d2 = d / 2;
  const float w = pm * gout[b] / cnt[b];
  const float* tb = table + (long long)b * N * d;
  const float* s = tb + (long long)src[be] * d;
  const float* o = tb + (long long)dst[be] * d;
  const float* r = rtab + (long long)rel[be] * d;
  const long long qt = ((long long)b * 2) * E + e, qh = qt + E;
  const float dsp_t = w * (expf(scpos[qt] - lse[qt]) - 1.f);
  const float dsp_h = w * (expf(scpos[qh] - lse[qh]) - 1.f);
  const float* pt = part_dq + (((long long)b * 2) * n_split * E + e) * d;
  const float* ph = part_dq + (((long long)b * 2 + 1) * n_split * E + e) * d;
  const long long stride = (long long)E * d;   // from one range to the next
  // the partials' weight (1 where final_dq weighted them), the rows' and
  // the outputs' rounding
  const float wp = kBf16 ? 1.f : w;
  auto row = [](float v) { return kBf16 ? round_bf16(v) : v; };
  auto rel_row = [](float v) { return kBf16 ? hilo_bf16(v) : v; };
  for (int c = lane; c < d2; c += kWarp) {
    const float s_re = row(s[c]), s_im = row(s[c + d2]);
    const float o_re = row(o[c]), o_im = row(o[c + d2]);
    const float r_re = rel_row(r[c]), r_im = rel_row(r[c + d2]);
    float at_re = 0.f, at_im = 0.f, ah_re = 0.f, ah_im = 0.f;
    for (int k = 0; k < n_split; ++k) {
      at_re += pt[k * stride + c];
      at_im += pt[k * stride + c + d2];
      ah_re += ph[k * stride + c];
      ah_im += ph[k * stride + c + d2];
    }
    // tail: qhat = s * r, positive row o
    float dq_re = wp * at_re + dsp_t * o_re;
    float dq_im = wp * at_im + dsp_t * o_im;
    float gs_re = dq_re * r_re + dq_im * r_im;
    float gs_im = -dq_re * r_im + dq_im * r_re;
    float gr_re = dq_re * s_re + dq_im * s_im;
    float gr_im = -dq_re * s_im + dq_im * s_re;
    float go_re = dsp_t * qhat[qt * d + c];
    float go_im = dsp_t * qhat[qt * d + c + d2];
    // head: qhat = conj(r) * o in ComplEx terms, positive row s
    dq_re = wp * ah_re + dsp_h * s_re;
    dq_im = wp * ah_im + dsp_h * s_im;
    go_re += dq_re * r_re - dq_im * r_im;
    go_im += dq_re * r_im + dq_im * r_re;
    gr_re += dq_re * o_re + dq_im * o_im;
    gr_im += dq_re * o_im - dq_im * o_re;
    gs_re += dsp_h * qhat[qh * d + c];
    gs_im += dsp_h * qhat[qh * d + c + d2];
    ds_row[c] = row(gs_re);
    ds_row[c + d2] = row(gs_im);
    do_row[c] = row(go_re);
    do_row[c + d2] = row(go_im);
    dr_row[c] = row(gr_re);
    dr_row[c + d2] = row(gr_im);
  }
}

// Block = 64 table rows of one element: the sum over both directions and
// all positive queries q of w_q * p_qn * qhat_q, then the subject and object
// row cotangents of the element's positive edges, in edge order. A query
// tile: its scores against the block's rows (score_product, K3's), then
// w * p into ps, then d_table += P^T Q (cot_product).
__global__ void __launch_bounds__(kLossThreads, 2) final_dtable_kernel(
    const float* __restrict__ table, const float* __restrict__ qhat,
    const float* __restrict__ lse, const float* __restrict__ posm,
    const float* __restrict__ cnt, const float* __restrict__ gout,
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ t_ptr, const int* __restrict__ t_ans,
    const int* __restrict__ h_ptr, const int* __restrict__ h_ans,
    const float* __restrict__ d_s, const float* __restrict__ d_o,
    float* __restrict__ d_table, int N, int E, int d) {
  const int ld = tc_ld(d);
  LossSmem s = loss_smem(ld, 1);
  const int n0 = blockIdx.x * kC, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* tb = table + (long long)b * N * d;
  const float* pm = posm + (long long)b * E;
  const float gw = gout[b] / cnt[b];
  stage_rows(s.ts, ld, tb, n0, d, [&](int r) { return n0 + r < N; });

  float acc[kMaxNt][4];
  zero_rows(acc);
  for (int dir = 0; dir < 2; ++dir) {
    const int* aptr = (dir == 0 ? t_ptr : h_ptr) + (long long)b * (E + 1);
    const int* ans = dir == 0 ? t_ans : h_ans;
    const long long qrow = ((long long)b * 2 + dir) * E;
    for (int q0 = 0; q0 < E; q0 += kQ) {
      __syncthreads();
      stage_rows(s.qs, ld, qhat, qrow + q0, d, [&](int r) {
        return q0 + r < E && pm[q0 + r] > 0.f;
      });
      if (tid < kQ) {
        const int e = q0 + tid;
        const bool on = e < E && pm[e] > 0.f;
        s.w[tid] = on ? pm[e] * gw : 0.f;
        s.l[tid] = on ? lse[qrow + e] : 0.f;
        unsigned long long bits = 0ull;
        if (on) {
          for (int c = aptr[e], ce = aptr[e + 1]; c < ce; ++c) {
            const int a = ans[c];
            if (a >= n0 + kC) break;
            if (a >= n0) bits |= 1ull << (a - n0);
          }
        }
        s.mb[tid] = bits;
      }
      cp_async_wait<0>();
      __syncthreads();
      float sc[4][4];
      score_product(s.qs, s.ts, ld, d, sc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = score_row(2 * h);
        const unsigned long long bits = s.mb[q];
        const float w = s.w[q], l = s.l[q];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = score_col(nt, 2 * h + j);
            const bool ok = w != 0.f && n0 + c < N && !((bits >> c) & 1ull);
            s.ps[q * kLdDt + c] = ok ? w * expf(sc[nt][2 * h + j] - l) : 0.f;
          }
      }
      __syncthreads();
      cot_product<true>(s.ps, kLdDt, s.qs, ld, d, acc);
    }
  }
  cp_async_wait<0>();
  // the subject and object rows of the positive edges, relative to the
  // block's (-1: not a positive), kLossThreads edges at a time in shared
  // memory (over the query tile); each thread adds the rows of its own
  // rows score_row(0) and score_row(2), in edge order
  const int nts = d / 16;
  int* er = reinterpret_cast<int*>(s.qs);
  for (int e0 = 0; e0 < E; e0 += kLossThreads) {
    __syncthreads();
    const int e = e0 + tid;
    int rs = -1, ro = -1;
    if (e < E && pm[e] > 0.f) {
      rs = src[(long long)b * E + e] - n0;
      ro = dst[(long long)b * E + e] - n0;
    }
    er[2 * tid] = rs;
    er[2 * tid + 1] = ro;
    __syncthreads();
    const int n = min(kLossThreads, E - e0);
    for (int i = 0; i < n; ++i) {
      const int es = er[2 * i], eo = er[2 * i + 1];
      const long long be = (long long)b * E + e0 + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = score_row(2 * h);
        if (es == r) {
#pragma unroll
          for (int nt = 0; nt < kMaxNt; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (nt < nts)
                acc[nt][2 * h + j] += d_s[be * d + cot_col(nt, j, d)];
        }
        if (eo == r) {
#pragma unroll
          for (int nt = 0; nt < kMaxNt; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (nt < nts)
                acc[nt][2 * h + j] += d_o[be * d + cot_col(nt, j, d)];
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kMaxNt; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + score_row(i);
      if (nt >= nts || n >= N) continue;
      d_table[((long long)b * N + n) * d + cot_col(nt, i, d)] = acc[nt][i];
    }
}

// -- K5 ----------------------------------------------------------------------
//
// In float32 only: K5's bfloat16 mode is fused_final_bf16.cu's own native
// kernels (window_bf16.cuh).
#if !TK_BF16

__global__ void __launch_bounds__(256, 2) final_bwd_gru_kernel(
    Layer p, const float* __restrict__ wih, const float* __restrict__ whh,
    float* dout, float* __restrict__ dprev, float* n2_out,
    float* __restrict__ conv_s, float* __restrict__ h0g_s,
    float* __restrict__ dgi_s, float* __restrict__ dgh_s,
    float* __restrict__ dconv_s, float* __restrict__ dlp_s) {
  bwd_gru_tile(p, wih, whh, dout, nullptr, dprev, n2_out, conv_s, h0g_s, dgi_s,
               dgh_s, dconv_s, dlp_s);
}

__global__ void final_bwd_input_kernel(
    const int* __restrict__ s_ptr, const int* __restrict__ s_dst,
    const int* __restrict__ s_rel, const float* __restrict__ s_em,
    const int* __restrict__ s_eid, const float* __restrict__ n2,
    const float* __restrict__ dconv_s, const float* __restrict__ dlp_s,
    const float* __restrict__ wrel, int wstride, int wcol,
    const float* __restrict__ loop_t, const float* __restrict__ x,
    float* __restrict__ ewg, float* out, int A, int d) {
  bwd_input_tile(s_ptr, s_dst, s_rel, s_em, s_eid, n2, dconv_s, dlp_s, wrel,
                 wstride, wcol, loop_t, x, ewg, out, 0, 1, A, d, 0);
}

__global__ void __launch_bounds__(kWgThreads, 4) final_wgrad_kernel(
    WJobs jobs, int B, int A,
                                   int rows_per_split,
                                   long long part_stride) {
  wgrad_tile(jobs, B, A, rows_per_split, part_stride);
}

__global__ void final_wgrad_reduce_kernel(const float* __restrict__ part,
                                          int n_split, long long total,
                                          float* __restrict__ out) {
  wgrad_reduce_one(part, n_split, total, out);
}

// -- K11 ---------------------------------------------------------------------

// A true answer's score in the ranks (ops/ranking.py NEG_INF).
constexpr float kNegRank = -1.0e7f;

// Block (query tile, column range) x direction x element of the fused
// eval. For each of its 64 query slots with qmask > 0: the query row (as
// final_scores_kernel builds it), then the target's score from a tile of
// the 64 targets' rows (score_product, its diagonal), so that a column whose
// row equals the target's scores exactly the same and does not count; then
// over the range's column tiles (kScoreBufs in flight, score_product) the
// count of the columns other than the target whose score, -1e7 at a true
// answer, is strictly greater: each thread over its own positions, then
// summed across the four threads of a row and the two warps of its rows.
// Range 0's tail blocks also write each target's tail score, which the BCE
// reads.
__global__ void __launch_bounds__(kLossThreads, 2) final_ranks_kernel(
    const float* __restrict__ table, const float* __restrict__ rtab,
    const int* __restrict__ qsrc, const int* __restrict__ qdst,
    const int* __restrict__ qrel, const float* __restrict__ qmask,
    const int* __restrict__ t_ptr, const int* __restrict__ t_ans,
    const int* __restrict__ h_ptr, const int* __restrict__ h_ans,
    int* __restrict__ part_cnt, float* __restrict__ tgt_tail, int N, int Q,
    int d, int n_split, int chunk) {
  const int ld = tc_ld(d), d2 = d / 2;
  LossSmem s = loss_smem(ld, kScoreBufs);
  const int n_qt = (Q + kQ - 1) / kQ;
  const int split = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kQ;
  const int dir = blockIdx.y, b = blockIdx.z;
  const int c_begin = min(N, split * chunk), c_end = min(N, c_begin + chunk);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const float* tb = table + (long long)b * N * d;
  const float* qm = qmask + (long long)b * Q;
  const int* ans = dir == 0 ? t_ans : h_ans;
  // the query slot's target row, or -1 for a slot that is not real
  auto target_of = [&](int r) -> long long {
    const int q = q0 + r;
    if (q >= Q || !(qm[q] > 0.f)) return -1;
    const long long bq = (long long)b * Q + q;
    return dir == 0 ? qdst[bq] : qsrc[bq];
  };
  auto stage = [&](int c0, int buf) {
    stage_rows(s.ts + buf * kC * ld, ld, tb, c0, d,
               [&](int r) { return c0 + r < c_end; });
  };
  // the targets' rows into the last buffer, the first column tile into
  // buffer 0
  stage_rows_at(s.ts + (kScoreBufs - 1) * kC * ld, ld, tb, d, target_of);
#pragma unroll
  for (int i = 0; i < kScoreBufs - 1; ++i) stage(c_begin + i * kC, i);

  for (int i = warp; i < kQ; i += kLossThreads / kWarp) {
    const int q = q0 + i;
    if (q < Q && qm[q] > 0.f) {
      const long long bq = (long long)b * Q + q;
      const float* sr = tb + (long long)qsrc[bq] * d;
      const float* orow = tb + (long long)qdst[bq] * d;
      const float* r = rtab + (long long)qrel[bq] * d;
      for (int c = lane; c < d2; c += kWarp) {
        float re, im;
        complex_query(dir, sr, orow, r, c, d2, re, im);
        s.qs[i * ld + c] = re;
        s.qs[i * ld + c + d2] = im;
      }
    } else {
      for (int c = lane; c < d; c += kWarp) s.qs[i * ld + c] = 0.f;
    }
  }
  init_cursors(s, (dir == 0 ? t_ptr : h_ptr) + (long long)b * (Q + 1), ans,
               qm, q0, Q, c_begin);
  cp_async_wait<0>();
  __syncthreads();
  {
    // each target's score: the diagonal of the queries against their
    // targets' rows, read by the one thread that holds it
    float acc[4][4];
    score_product(s.qs, s.ts + (kScoreBufs - 1) * kC * ld, ld, d, acc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = score_row(i);
        if (score_col(nt, i) != r) continue;
        s.w[r] = acc[nt][i];
        const int q = q0 + r;
        if (dir == 0 && split == 0 && q < Q && qm[q] > 0.f)
          tgt_tail[(long long)b * Q + q] = acc[nt][i];
      }
  }
  __syncthreads();

  // the thread's two rows (h = 0, 1: score_row(2 h)) over its columns
  bool on[2];
  int target[2], cnt[2] = {0, 0};
  float tgt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long t = target_of(score_row(2 * h));
    on[h] = t >= 0;
    target[h] = static_cast<int>(t);
    tgt[h] = s.w[score_row(2 * h)];
  }
  for (int c0 = c_begin, it = 0; c0 < c_end; c0 += kC, ++it) {
    __syncthreads();
    stage(c0 + (kScoreBufs - 1) * kC, (it + kScoreBufs - 1) % kScoreBufs);
    next_masks(s, ans, c0);
    cp_async_wait<kScoreBufs - 1>();
    __syncthreads();
    float acc[4][4];
    score_product(s.qs, s.ts + (it % kScoreBufs) * kC * ld, ld, d, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!on[h]) continue;
      const unsigned long long bits = s.mb[score_row(2 * h)];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = score_col(nt, 2 * h + j);
          if (c0 + c >= c_end || c0 + c == target[h]) continue;
          const float v = ((bits >> c) & 1ull) ? kNegRank
                                               : acc[nt][2 * h + j];
          cnt[h] += v > tgt[h] ? 1 : 0;
        }
    }
  }
  cp_async_wait<0>();
  // the four threads of a row, then the two warps of its rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      cnt[h] += __shfl_xor_sync(kFull, cnt[h], off);
  __syncthreads();
  const bool lead = (lane & 3) == 0;
  if ((warp & 1) && lead) {
#pragma unroll
    for (int h = 0; h < 2; ++h) s.cur[score_row(2 * h)] = cnt[h];
  }
  __syncthreads();
  if (!(warp & 1) && lead) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = score_row(2 * h), q = q0 + r;
      if (q < Q)
        part_cnt[(((long long)b * 2 + dir) * n_split + split) * Q + q] =
            cnt[h] + s.cur[r];
    }
  }
}

// One block per element: each query slot's rank, 1 + its counts summed
// over the column ranges (1 for a slot with qmask 0), into the [head ranks,
// tail ranks] layout; and the BCE of the positives, the mean over the
// masked slots of softplus(-tail score), summed by a fixed tree.
__global__ void final_rank_reduce_kernel(
    const int* __restrict__ part_cnt, const float* __restrict__ tgt_tail,
    const float* __restrict__ qmask, int* __restrict__ ranks,
    float* __restrict__ bce, int Q, int n_split) {
  __shared__ float red_l[kLossThreads], red_n[kLossThreads];
  const int b = blockIdx.x, tid = threadIdx.x;
  float l = 0.f, n = 0.f;
  for (int q = tid; q < Q; q += kLossThreads) {
    const long long bq = (long long)b * Q + q;
    for (int dir = 0; dir < 2; ++dir) {
      int c = 0;
      for (int sp = 0; sp < n_split; ++sp)
        c += part_cnt[(((long long)b * 2 + dir) * n_split + sp) * Q + q];
      ranks[(long long)b * 2 * Q + (dir == 0 ? Q : 0) + q] = 1 + c;
    }
    const float m = qmask[bq];
    if (m > 0.f) {
      const float x = -tgt_tail[bq];
      l += m * (x > 20.f ? x : log1pf(expf(x)));  // torch's softplus
      n += m;
    }
  }
  red_l[tid] = l;
  red_n[tid] = n;
  __syncthreads();
  for (int w = kLossThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red_l[tid] += red_l[tid + w];
      red_n[tid] += red_n[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) bce[b] = red_l[0] / fmaxf(red_n[0], 1.f);
}
#endif  // !TK_BF16

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int loss_chunk(int N, int n_split) {
  const int per = (N + n_split - 1) / n_split;
  return (per + kC - 1) / kC * kC;
}

}  // namespace

#if !TK_BF16
extern "C" int final_layer_launch(
    const void* x, const void* rowptr, const void* src, const void* rel,
    const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* dt,
    float lam, const void* prev, const void* sel_x, const void* active,
    void* out, int B, int N, int d, void* stream) {
  if (B > 0 && N > 0) {
    const Layer p = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                               wcol, loopw, mask, 0, wih_t, whh_t, bih, bhh,
                               nullptr, nullptr, dt, lam, prev, 1, N, d, 0);
    const int warps = fwd_warps(d, kFinalWarps);
    const int slabs = d / (16 * warps);
    const size_t smem = fwd_layer_smem_floats(d, warps) * sizeof(float);
    cudaError_t err = allow_smem(final_layer_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kBwdRows - 1) / kBwdRows * slabs, B);
    final_layer_kernel<<<grid, warps * kWarp, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const float*>(sel_x),
        static_cast<const float*>(active), static_cast<float*>(out), slabs);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // !TK_BF16

extern "C" int final_scores_launch(
    const void* table, const void* rtab, const void* src, const void* dst,
    const void* rel, const void* posm, const void* t_ptr, const void* t_ans,
    const void* h_ptr, const void* h_ans, void* part_m, void* part_s,
    void* qhat, void* scpos, int B, int N, int E, int d, int n_split,
    void* stream) {
  if (B > 0 && E > 0) {
    const size_t smem =
        loss_smem_floats(tc_ld(d), kScoreBufs, 0) * sizeof(float);
    cudaError_t err = allow_smem(final_scores_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the bfloat16 mode's two variants in the second grid dimension
    const dim3 grid(((E + kQ - 1) / kQ) * n_split, kBf16 ? 4 : 2, B);
    final_scores_kernel<<<grid, kLossThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(rtab),
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const int*>(rel), static_cast<const float*>(posm),
        static_cast<const int*>(t_ptr), static_cast<const int*>(t_ans),
        static_cast<const int*>(h_ptr), static_cast<const int*>(h_ans),
        static_cast<float*>(part_m), static_cast<float*>(part_s),
        static_cast<float*>(qhat), static_cast<float*>(scpos), N, E, d,
        n_split, loss_chunk(N, n_split));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int final_loss_reduce_launch(
    const void* part_m, const void* part_s, const void* scpos,
    const void* posm, void* lse, void* cnt, void* loss, int B, int E,
    int n_split, void* stream) {
  if (B > 0) {
    final_loss_reduce_kernel<<<B, kLossThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_s),
        static_cast<const float*>(scpos), static_cast<const float*>(posm),
        static_cast<float*>(lse), static_cast<float*>(cnt),
        static_cast<float*>(loss), E, n_split);
  }
  return static_cast<int>(cudaGetLastError());
}

// cnt, gout: the count and the cotangent of each element's loss (read by
// the bfloat16 mode only).
extern "C" int final_dq_launch(
    const void* table, const void* qhat, const void* lse, const void* posm,
    const void* t_ptr, const void* t_ans, const void* h_ptr,
    const void* h_ans, const void* cnt, const void* gout, void* part_dq,
    int B, int N, int E, int d, int n_split, void* stream) {
  if (B > 0 && E > 0) {
    const size_t smem =
        loss_smem_floats(tc_ld(d), 1, kQ * kLdDq) * sizeof(float);
    cudaError_t err = allow_smem(final_dq_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(((E + kQ - 1) / kQ) * n_split, 2, B);
    final_dq_kernel<<<grid, kLossThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(qhat),
        static_cast<const float*>(lse), static_cast<const float*>(posm),
        static_cast<const int*>(t_ptr), static_cast<const int*>(t_ans),
        static_cast<const int*>(h_ptr), static_cast<const int*>(h_ans),
        static_cast<const float*>(cnt), static_cast<const float*>(gout),
        static_cast<float*>(part_dq), N, E, d, n_split,
        loss_chunk(N, n_split));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int final_dq_finish_launch(
    const void* table, const void* rtab, const void* src, const void* dst,
    const void* rel, const void* posm, const void* qhat, const void* scpos,
    const void* lse, const void* cnt, const void* gout, const void* part_dq,
    void* d_s, void* d_o, void* d_remb, int B, int N, int E, int d,
    int n_split, void* stream) {
  if (B > 0 && E > 0) {
    constexpr int kWarps = 8;
    const dim3 grid((E + kWarps - 1) / kWarps, B);
    final_dq_finish_kernel<<<grid, kWarps * kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(rtab),
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const int*>(rel), static_cast<const float*>(posm),
        static_cast<const float*>(qhat), static_cast<const float*>(scpos),
        static_cast<const float*>(lse), static_cast<const float*>(cnt),
        static_cast<const float*>(gout), static_cast<const float*>(part_dq),
        static_cast<float*>(d_s), static_cast<float*>(d_o),
        static_cast<float*>(d_remb), N, E, d, n_split);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int final_dtable_launch(
    const void* table, const void* qhat, const void* lse, const void* posm,
    const void* cnt, const void* gout, const void* src, const void* dst,
    const void* t_ptr, const void* t_ans, const void* h_ptr,
    const void* h_ans, const void* d_s, const void* d_o, void* d_table,
    int B, int N, int E, int d, void* stream) {
  if (B > 0 && N > 0) {
    const size_t smem =
        loss_smem_floats(tc_ld(d), 1, kQ * kLdDt) * sizeof(float);
    cudaError_t err = allow_smem(final_dtable_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kC - 1) / kC, B);
    final_dtable_kernel<<<grid, kLossThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(qhat),
        static_cast<const float*>(lse), static_cast<const float*>(posm),
        static_cast<const float*>(cnt), static_cast<const float*>(gout),
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const int*>(t_ptr), static_cast<const int*>(t_ans),
        static_cast<const int*>(h_ptr), static_cast<const int*>(h_ans),
        static_cast<const float*>(d_s), static_cast<const float*>(d_o),
        static_cast<float*>(d_table), N, E, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The relation and weight sums read and write float32 only: the float32
// build's serve both modes. K5's launchers: fused_final_bf16.cu has the
// bfloat16 mode's.
#if !TK_BF16
extern "C" int final_rel_grad_launch(const void* r_ptr, const void* r_eid,
                                     const void* vals, void* out, int n_rels,
                                     int d, void* stream) {
  return static_cast<int>(
      rel_sum(r_ptr, r_eid, vals, nullptr, out, n_rels, d, stream));
}

extern "C" int final_bwd_gru_launch(
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
                               nullptr, nullptr, dt, lam, prev, 1, N, d, 0);
    return static_cast<int>(launch_bwd_tile(
        final_bwd_gru_kernel, bwd_gru_smem_floats(d), B, N, d, stream, p,
        static_cast<const float*>(wih), static_cast<const float*>(whh),
        const_cast<float*>(static_cast<const float*>(dout)),
        static_cast<float*>(dprev), static_cast<float*>(n2_out),
        static_cast<float*>(conv_s), static_cast<float*>(h0g_s),
        static_cast<float*>(dgi_s), static_cast<float*>(dgh_s),
        static_cast<float*>(dconv_s), static_cast<float*>(dlp_s)));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int final_bwd_input_launch(
    const void* s_ptr, const void* s_dst, const void* s_rel,
    const void* s_em, const void* s_eid, const void* n2,
    const void* dconv_s, const void* dlp_s, const void* wrel, int wstride,
    int wcol, const void* loop_t, const void* x, void* ewg, void* out, int B,
    int N, int d, void* stream) {
  if (B > 0 && N > 0) {
    return static_cast<int>(launch_bwd_tile(
        final_bwd_input_kernel, bwd_input_smem_floats(d), B, N, d, stream,
        static_cast<const int*>(s_ptr), static_cast<const int*>(s_dst),
        static_cast<const int*>(s_rel), static_cast<const float*>(s_em),
        static_cast<const int*>(s_eid), static_cast<const float*>(n2),
        static_cast<const float*>(dconv_s), static_cast<const float*>(dlp_s),
        static_cast<const float*>(wrel), wstride, wcol,
        static_cast<const float*>(loop_t), static_cast<const float*>(x),
        static_cast<float*>(ewg), static_cast<float*>(out), N, d));
  }
  return static_cast<int>(cudaGetLastError());
}

// The three weight jobs of one layer over its B*N rows: (conv, d_gi) ->
// dwih + dbih, (h0g, d_gh) -> dwhh + dbhh, (x, d_lp) -> dloop. `part` holds
// n_split copies of the flat outputs, each laid out dwih [d, 3d], dbih [3d],
// dwhh [d, 3d], dbhh [3d], dloop [d, d]; it must start at zero.
extern "C" int final_wgrad_launch(
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
    WJobs jobs = {};
    jobs.job[0] = make_job(conv_s, sd, dgi_s, sg, wih, bih, d, 3 * d, &first);
    jobs.job[1] = make_job(h0g_s, sd, dgh_s, sg, whh, bhh, d, 3 * d, &first);
    jobs.job[2] = make_job(x, sd, dlp_s, sd, loop, nullptr, d, d, &first);
    for (int j = 3; j < kWgJobs; ++j) jobs.job[j].first = kNoJob;
    return static_cast<int>(launch_wgrad(final_wgrad_kernel, jobs, first,
                                         n_split, B, N, total, stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int final_wgrad_reduce_launch(const void* part, int n_split,
                                         long long total, void* out,
                                         void* stream) {
  if (total > 0) {
    const int threads = 256;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    final_wgrad_reduce_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part), n_split, total,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int final_ranks_launch(
    const void* table, const void* rtab, const void* qsrc, const void* qdst,
    const void* qrel, const void* qmask, const void* t_ptr,
    const void* t_ans, const void* h_ptr, const void* h_ans, void* part_cnt,
    void* tgt_tail, int B, int N, int Q, int d, int n_split, void* stream) {
  if (B > 0 && Q > 0) {
    const size_t smem =
        loss_smem_floats(tc_ld(d), kScoreBufs, 0) * sizeof(float);
    cudaError_t err = allow_smem(final_ranks_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(((Q + kQ - 1) / kQ) * n_split, 2, B);
    final_ranks_kernel<<<grid, kLossThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(rtab),
        static_cast<const int*>(qsrc), static_cast<const int*>(qdst),
        static_cast<const int*>(qrel), static_cast<const float*>(qmask),
        static_cast<const int*>(t_ptr), static_cast<const int*>(t_ans),
        static_cast<const int*>(h_ptr), static_cast<const int*>(h_ans),
        static_cast<int*>(part_cnt), static_cast<float*>(tgt_tail), N, Q, d,
        n_split, loss_chunk(N, n_split));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int final_rank_reduce_launch(const void* part_cnt,
                                        const void* tgt_tail,
                                        const void* qmask, void* ranks,
                                        void* bce, int B, int Q, int n_split,
                                        void* stream) {
  if (B > 0) {
    final_rank_reduce_kernel<<<B, kLossThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(part_cnt),
        static_cast<const float*>(tgt_tail),
        static_cast<const float*>(qmask), static_cast<int*>(ranks),
        static_cast<float*>(bce), Q, n_split);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // !TK_BF16
