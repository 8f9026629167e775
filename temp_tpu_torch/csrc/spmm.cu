// Relational SpMM for diagonal relation weights (n_bases == d): forward
// (K1f) and backward (K1b), one launch a call over static CSR tables of
// the snapshots the call names.
//
// A call takes B graphs side by side: graph b has rows [b * n, (b + 1) * n)
// of h, out, g and dh, its edges are those of snapshot t_b of the tables,
// and mask[b, e] says which of them the call keeps. K1f replaces the TPU
// kernel temp_tpu/ops/pallas_spmm.py:_fwd_kernel (reached through
// rel_spmm_pallas). For every row v of graph b it computes
//
//     out[b, v] = norm[b, v]^2 * sum_{e in fwd(t_b, v), mask[b, e]}
//                                   h[b, src_e] * w[rel_e]
//     norm = 1 / deg  (0 where deg == 0),  deg[b, v] = the count of those e
//
// (the reference's double degree normalization) and writes norm^2 for the
// backward. K1b replaces temp_tpu/ops/pallas_spmm.py:_bwd_kernel (with
// _spmm_bwd). With g the cotangent of out and dmsg_e = g[b, dst_e] *
// norm[b, dst_e]^2:
//
//     dh[b, u] = sum_{e in src(t_b, u), mask[b, e]} dmsg_e * w[rel_e]
//     dw[r]    = sum_{b = 0 .. B - 1} sum_{e in rel(t_b, r), mask[b, e]}
//                    dmsg_e * h[b, src_e]
//
// The tables (RingTables with m = 1, temp_tpu_torch/parallel/
// edge_partition.py) hold each snapshot's edges sorted by destination
// (edges: src, rel, slot), by source (dst, rel, slot) and by relation
// (src, dst, slot), each ordering with its row pointer, and only the
// slots of the static mask. They are the data's, sorted once with the
// dataset (temp_tpu_torch/data/snapshots.py ring_layout), or, for a call
// whose graphs are no train snapshots, the call's own edges sorted by the
// wrapper. A warp reads its graph's time position t_b (a device assert
// stops a position outside the tables' [0, T)), finds its row in that
// snapshot's block and reads the call's mask per edge (always a subset of
// the static mask). So a call makes no sort, no degree pass and no host
// sync: one launch and two outputs.
//
// What bounds both on an H100: memory. Each kept edge gathers two rows of
// d floats (h or g, and w or h) and does 3 flops a column, and each output
// row is written once; there is no product or tile that tensor cores,
// wgmma or TMA could take. At the main path's sizes h ([7128, 128] f32,
// 3.6 MB) and w stay in the 50 MB L2, so the rows come from there.
//
// What the design does about that: one warp owns one output row (a
// (graph, row) of out or dh, a relation of dw), sums in registers and
// writes the row once. At d = 128 each lane reads one float4 of a gathered
// row, so a row is one 512-byte coalesced read (d not a multiple of 4 or a
// pointer not 16-byte aligned: one float a lane). The warp loads the index
// triples and mask bytes of 32 edges at once, one edge a lane, keeps the
// kept ones as a ballot, and gathers the rows of up to kAhead kept edges
// before it sums them, so several row loads are in flight a warp on long
// rows (K1b's relations, the conv1 table). Each row sums in its edge (slot)
// order, with no atomics and no block waiting on another: runs repeat bit
// for bit, and the tables of the data and those sorted in the call give
// each row the same edges in the same order, so the two routes agree bit
// for bit. K1b is one launch: warps below B * n give dh rows, the rest dw
// rows, each relation walking the graphs in order b = 0 .. B - 1.
//
// Compiled a second time as spmm_bf16.cu, with TK_BF16 1: the TPU kernels'
// bfloat16 instantiation (_fwd_kernel and _bwd_kernel with dtype_str
// "bfloat16", reached through rel_spmm's method "pallas"), whose one-hot
// products round what they gather. With r(x) x rounded to bfloat16 (to
// nearest, ties to even, as XLA's convert), K1f reads w as float32 and h
// as it is given, float32 or bfloat16 (a bfloat16 h comes from the
// windows' bfloat16 buffers), rounds every gathered value to bfloat16 in
// registers (the identity on a bfloat16 one), as the TPU kernel's body
// does, and sums
// the messages r(r(h[src_e]) * r(w[rel_e])) in float32 (a product of two
// bfloat16 values is exact in float32, so only the outer r rounds); the
// degrees and norm^2 stay exact and out float32. K1b is the TPU kernels'
// transpose on those rounded values: with dmsg_e = r(g[dst_e] * n2[dst_e])
// (the TPU kernel rounds g * norm^2 once a row, before its gather by dst:
// the same value), dh sums r(dmsg_e * r(w[rel_e])) and dw r(dmsg_e *
// r(h[src_e])), g, n2, dh and dw float32. The launchers' h_bf16 says
// whether h is bfloat16; the float32 build takes a float32 h only, and its
// arithmetic is unchanged (r is the identity there).
//
// The bfloat16 build has a second rounding mode, the launchers' onehot = 1:
// the function of rel_spmm's method "onehot" in bfloat16 (the JAX
// package's _rel_spmm_onehot with dtype=bfloat16, XLA ops there, no Pallas
// kernel), whose one-hot products gather rows rounded to bfloat16 and
// scale each message before its sum. With norm = 1 / deg of the row v:
//
//     out[b, v] = norm * sum_e r(r(r(h[src_e]) * r(w[rel_e])) * r(norm))
//
// (float32 sums), and norm, not norm^2, goes to n2_out for the backward.
// A warp counts its row's kept edges first, to know norm before the sum.
// K1b in that mode is the transpose of those casts and products: with
// dmsg_e = r(r(g[dst_e] * norm[dst_e]) * r(norm[dst_e])),
//
//     dh[b, u] = r(sum_e r(dmsg_e * r(w[rel_e])))
//     dw[r]    = the terms r(dmsg_e * r(h[b, src_e])) of every graph b in
//                order, each graph's edges in slot order, added one by
//                one with each partial sum rounded
//
// dh's sum float32 and rounded once, as the transpose of the JAX
// package's one-hot product of the rounded h; dw's in bfloat16 in the
// edges' order, as the JAX package's scatter-add transposes its gather of
// the rounded weights (XLA's scatter-add of a bfloat16 operand on the CPU,
// update by update).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cassert>
#include <tuple>
#include <type_traits>

#ifndef TK_BF16
#define TK_BF16 0
#endif

namespace {

constexpr bool kBf16 = TK_BF16 != 0;

// x rounded to bfloat16 in the bfloat16 mode, x itself otherwise
__device__ __forceinline__ float hot(float x) {
  if constexpr (kBf16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxD = 256;   // the wrapper refuses d > 256
constexpr int kAhead = 2;    // kept edges whose rows a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

// One snapshot's block of a table for graph b: its row pointer (n_keys + 1
// entries), its edges (cap x 3 ints) and graph b's row of the mask.
struct Block {
  const int* ptr;
  const int* edge;
  const unsigned char* mask;
};

__device__ __forceinline__ Block table_block(const int* ptr, const int* edge,
                                             const long long* tpos,
                                             int n_times,
                                             const unsigned char* mask,
                                             int b, int n_keys, int cap) {
  const long long tp = tpos[b];
  assert(tp >= 0 && tp < n_times);  // a time position outside the tables
  return {ptr + tp * (n_keys + 1), edge + tp * cap * 3LL,
          mask + (long long)b * cap};
}

// V floats a lane, at columns (c * 32 + lane) * V .. + V - 1 for chunk c.
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

// V bfloat16 values a lane (one 8-byte load for V = 4), widened exactly
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&x)[V]) {
  if constexpr (V == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&x)[V], float scale) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  } else {
    p[0] = x[0] * scale;
  }
}

// A lane holds C chunks of V columns of a row: C * 32 * V >= d. The
// launchers take the fewest chunks that cover d, since the registers of
// the rows in flight bound how many warps an SM holds.

// The number of kept edges of [e0, e1) of a block (a row's degree).
__device__ __forceinline__ int count_kept(const int* __restrict__ edge,
                                          const unsigned char* __restrict__ mask,
                                          int e0, int e1, int lane) {
  int n = 0;
  for (int base = e0; base < e1; base += kWarp) {
    const int e = base + lane;
    const bool keep = e < e1 && mask[edge[3LL * e + 2]] != 0;
    n += __popc(__ballot_sync(kFull, keep));
  }
  return n;
}

// Adds to acc, in edge order, the kept edges of [e0, e1) of a block: edge
// e brings ints (x0, x1, slot) and is kept where mask[slot] != 0; its term
// is a[col] * b[col] for kScaled false (K1f: a = A[x_ia], b = Bm[x_ib]) and
// a[col] * s * b[col] with s = S[x_ia] for kScaled true (K1b); in the
// bfloat16 mode r(r(a[col]) * r(b[col])) and r(r(a[col] * s) * r(b[col])),
// and with kOneHot (the "onehot" mode) r(r(r(a[col]) * r(b[col])) * post)
// and r(r(r(a[col] * s) * r(s)) * r(b[col])); kSeq rounds acc after each
// add. Returns the number of kept edges (K1f's degree).
template <int V, int C, bool kScaled, bool kOneHot = false,
          bool kSeq = false, typename TA, typename TB>
__device__ __forceinline__ int walk(const int* __restrict__ edge,
                                    const unsigned char* __restrict__ mask,
                                    int e0, int e1, int lane, int d,
                                    const TA* __restrict__ A, int ia,
                                    const float* __restrict__ S,
                                    const TB* __restrict__ Bm, int ib,
                                    float (&acc)[C][V], float post = 0.f) {
  int n_kept = 0;
  for (int base = e0; base < e1; base += kWarp) {
    const int e = base + lane;
    int xa = 0, xb = 0;
    bool keep = false;
    if (e < e1) {
      const int* x = edge + 3LL * e;
      xa = x[ia];
      xb = x[ib];
      keep = mask[x[2]] != 0;
    }
    unsigned kept = __ballot_sync(kFull, keep);  // the same in every lane
    n_kept += __popc(kept);
    while (kept != 0u) {
      int qa[kAhead], qb[kAhead];
      int k = 0;
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int j = kept != 0u ? __ffs(kept) - 1 : 0;
        qa[q] = __shfl_sync(kFull, xa, j);
        qb[q] = __shfl_sync(kFull, xb, j);
        if (kept != 0u) {
          ++k;
          kept &= kept - 1;
        }
      }
      // the rows of k kept edges in flight, then summed in edge order
      float av[kAhead][C][V], bv[kAhead][C][V], sv[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        if (q < k) {
          if constexpr (kScaled) sv[q] = __ldg(S + qa[q]);
          const TA* ra = A + (long long)qa[q] * d;
          const TB* rb = Bm + (long long)qb[q] * d;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int col = (c * kWarp + lane) * V;
            if (col < d) {
              load_vec<V>(ra + col, av[q][c]);
              load_vec<V>(rb + col, bv[q][c]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        if (q < k) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if ((c * kWarp + lane) * V < d) {
#pragma unroll
              for (int i = 0; i < V; ++i) {
                if constexpr (kScaled && kOneHot && kSeq)
                  acc[c][i] = hot(acc[c][i] +
                                  hot(hot(hot(av[q][c][i] * sv[q])
                                          * hot(sv[q])) * hot(bv[q][c][i])));
                else if constexpr (kScaled && kOneHot)
                  acc[c][i] += hot(hot(hot(av[q][c][i] * sv[q]) * hot(sv[q]))
                                   * hot(bv[q][c][i]));
                else if constexpr (kScaled)
                  acc[c][i] +=
                      hot(hot(av[q][c][i] * sv[q]) * hot(bv[q][c][i]));
                else if constexpr (kOneHot)
                  acc[c][i] += hot(
                      hot(__fmul_rn(hot(av[q][c][i]), hot(bv[q][c][i])))
                      * post);
                else
                  acc[c][i] +=
                      hot(__fmul_rn(hot(av[q][c][i]), hot(bv[q][c][i])));
              }
            }
          }
        }
      }
    }
  }
  return n_kept;
}

template <int V, int C>
__device__ __forceinline__ void store_row(float* __restrict__ o,
                                          const float (&acc)[C][V], int lane,
                                          int d, float scale) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (c * kWarp + lane) * V;
    if (col < d) store_vec<V>(o + col, acc[c], scale);
  }
}

// acc rounded, entry by entry (the "onehot" mode's dh sums)
template <int V, int C>
__device__ __forceinline__ void round_acc(float (&acc)[C][V]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[c][i] = hot(acc[c][i]);
}

// One warp a (graph, row): the table by destination. kOneHot: the
// "onehot" rounding mode (bfloat16 build only).
template <int V, int C, typename TH, bool kOneHot>
__global__ void spmm_fwd_kernel(const int* __restrict__ ptr,
                                const int* __restrict__ edge,
                                const long long* __restrict__ tpos,
                                int n_times,
                                const unsigned char* __restrict__ mask,
                                const TH* __restrict__ h,
                                const float* __restrict__ w,
                                float* __restrict__ out,
                                float* __restrict__ n2_out, int B, int n,
                                int rows, int cap, int d) {
  const int lane = threadIdx.x % kWarp;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= (long long)B * n) return;
  const int b = static_cast<int>(warp / n);
  const int v = static_cast<int>(warp % n);
  const Block t = table_block(ptr, edge, tpos, n_times, mask, b, rows, cap);
  float acc[C][V] = {};
  if constexpr (kOneHot) {
    // the scale of every message of the row is r(norm): the degree first
    const int deg = count_kept(t.edge, t.mask, t.ptr[v], t.ptr[v + 1], lane);
    const float fdeg = static_cast<float>(deg);
    const float norm = fdeg > 0.f ? 1.f / fdeg : 0.f;
    walk<V, C, false, true>(t.edge, t.mask, t.ptr[v], t.ptr[v + 1], lane,
                            d, h + (long long)b * n * d, 0, nullptr, w, 1,
                            acc, hot(norm));
    store_row<V, C>(out + warp * d, acc, lane, d, norm);
    if (lane == 0) n2_out[warp] = norm;
    return;
  }
  const int deg = walk<V, C, false>(t.edge, t.mask, t.ptr[v], t.ptr[v + 1],
                                 lane, d, h + (long long)b * n * d, 0,
                                 nullptr, w, 1, acc);
  const float fdeg = static_cast<float>(deg);
  const float norm = fdeg > 0.f ? 1.f / fdeg : 0.f;
  const float n2 = norm * norm;
  store_row<V, C>(out + warp * d, acc, lane, d, n2);
  if (lane == 0) n2_out[warp] = n2;
}

// Warps [0, B * n): dh of a (graph, row) over the table by source; warps
// [B * n, B * n + n_rels): dw of a relation over the tables by relation of
// the B graphs in order. kOneHot: the "onehot" mode (n2 holds norm).
template <int V, int C, typename TH, bool kOneHot>
__global__ void spmm_bwd_kernel(const int* __restrict__ s_ptr,
                                const int* __restrict__ s_edge,
                                const int* __restrict__ r_ptr,
                                const int* __restrict__ r_edge,
                                const long long* __restrict__ tpos,
                                int n_times,
                                const unsigned char* __restrict__ mask,
                                const float* __restrict__ g,
                                const float* __restrict__ n2,
                                const TH* __restrict__ h,
                                const float* __restrict__ w,
                                float* __restrict__ dh,
                                float* __restrict__ dw, int B, int n,
                                int rows, int cap, int n_rels, int d) {
  const int lane = threadIdx.x % kWarp;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long n_dh = (long long)B * n;
  if (warp >= n_dh + n_rels) return;
  float acc[C][V] = {};
  if (warp < n_dh) {
    const int b = static_cast<int>(warp / n);
    const int u = static_cast<int>(warp % n);
    const Block t =
        table_block(s_ptr, s_edge, tpos, n_times, mask, b, rows, cap);
    const long long off = (long long)b * n;
    // edge (dst, rel, slot): g[dst] * n2[dst] * w[rel]
    walk<V, C, true, kOneHot>(t.edge, t.mask, t.ptr[u], t.ptr[u + 1], lane,
                              d, g + off * d, 0, n2 + off, w, 1, acc);
    if constexpr (kOneHot) round_acc<V, C>(acc);
    store_row<V, C>(dh + warp * d, acc, lane, d, 1.f);
  } else {
    const int r = static_cast<int>(warp - n_dh);
    for (int b = 0; b < B; ++b) {
      const Block t =
          table_block(r_ptr, r_edge, tpos, n_times, mask, b, n_rels, cap);
      const long long off = (long long)b * n;
      // edge (src, dst, slot): g[dst] * n2[dst] * h[src]
      walk<V, C, true, kOneHot, kOneHot>(t.edge, t.mask, t.ptr[r],
                                         t.ptr[r + 1], lane, d, g + off * d,
                                         1, n2 + off, h + off * d, 0, acc);
    }
    store_row<V, C>(dw + (long long)r * d, acc, lane, d, 1.f);
  }
}

int blocks_for(long long warps) {
  return static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

constexpr int kThreads = kWarpsPerBlock * kWarp;

// Calls f(TH{}, OneHot{}) with TH the type of h: bfloat16 where h_bf16 is
// 1, float otherwise, and OneHot std::true_type where onehot is 1 (both
// the bfloat16 build only). Returns the launch's error.
template <typename F>
int with_h_type(int h_bf16, int onehot, F&& f) {
  if (onehot != 0 && (!kBf16 || onehot != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h_bf16 != 0 && (!kBf16 || h_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kBf16) {
    if (h_bf16 == 1 && onehot == 1)
      f(__nv_bfloat16{}, std::true_type{});
    else if (h_bf16 == 1)
      f(__nv_bfloat16{}, std::false_type{});
    else if (onehot == 1)
      f(float{}, std::true_type{});
    else
      f(float{}, std::false_type{});
  } else {
    f(float{}, std::false_type{});
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V, int C, typename TH, bool kOneHot>
void fwd(cudaStream_t s, long long warps, const int* p, const int* e,
         const long long* tp, int n_times, const unsigned char* m,
         const TH* h, const float* w, float* o, float* o2, int B, int n,
         int rows, int cap, int d) {
  spmm_fwd_kernel<V, C, TH, kOneHot><<<blocks_for(warps), kThreads, 0, s>>>(
      p, e, tp, n_times, m, h, w, o, o2, B, n, rows, cap, d);
}

template <int V, int C, typename TH, bool kOneHot>
void bwd(cudaStream_t s, long long warps, const int* sp, const int* se,
         const int* rp, const int* re, const long long* tp, int n_times,
         const unsigned char* m, const float* g, const float* n2,
         const TH* h, const float* w, float* dh, float* dw, int B, int n,
         int rows, int cap, int n_rels, int d) {
  spmm_bwd_kernel<V, C, TH, kOneHot><<<blocks_for(warps), kThreads, 0, s>>>(
      sp, se, rp, re, tp, n_times, m, g, n2, h, w, dh, dw, B, n, rows, cap,
      n_rels, d);
}

}  // namespace

// vec: 4 (four values a lane; d % 4 == 0 and rows aligned to four
// values) or 1. h_bf16: 1 for a bfloat16 h (the bfloat16 build only);
// w is float32. onehot: 1 for the "onehot" rounding mode (the bfloat16
// build only; n2_out then holds norm).
extern "C" int spmm_fwd_launch(const void* ptr, const void* edge,
                               const void* tpos, int n_times,
                               const void* mask, const void* h,
                               const void* w, void* out, void* n2_out, int B,
                               int n, int rows, int cap, int d, int vec,
                               int h_bf16, int onehot, void* stream) {
  const long long warps = (long long)B * n;
  return with_h_type(h_bf16, onehot, [&](auto th, auto oh) {
    using TH = decltype(th);
    constexpr bool kOH = decltype(oh)::value;
    if (warps <= 0) return;
    const auto args = std::make_tuple(
        static_cast<cudaStream_t>(stream), warps,
        static_cast<const int*>(ptr), static_cast<const int*>(edge),
        static_cast<const long long*>(tpos), n_times,
        static_cast<const unsigned char*>(mask), static_cast<const TH*>(h),
        static_cast<const float*>(w), static_cast<float*>(out),
        static_cast<float*>(n2_out), B, n, rows, cap, d);
    if (vec == 4 && d <= kWarp * 4)
      std::apply(fwd<4, 1, TH, kOH>, args);
    else if (vec == 4)
      std::apply(fwd<4, kMaxD / (kWarp * 4), TH, kOH>, args);
    else
      std::apply(fwd<1, kMaxD / kWarp, TH, kOH>, args);
  });
}

extern "C" int spmm_bwd_launch(const void* s_ptr, const void* s_edge,
                               const void* r_ptr, const void* r_edge,
                               const void* tpos, int n_times,
                               const void* mask, const void* g,
                               const void* n2, const void* h, const void* w,
                               void* dh, void* dw, int B, int n, int rows,
                               int cap, int n_rels, int d, int vec,
                               int h_bf16, int onehot, void* stream) {
  const long long warps = (long long)B * n + n_rels;
  return with_h_type(h_bf16, onehot, [&](auto th, auto oh) {
    using TH = decltype(th);
    constexpr bool kOH = decltype(oh)::value;
    if (warps <= 0) return;
    const auto args = std::make_tuple(
        static_cast<cudaStream_t>(stream), warps,
        static_cast<const int*>(s_ptr), static_cast<const int*>(s_edge),
        static_cast<const int*>(r_ptr), static_cast<const int*>(r_edge),
        static_cast<const long long*>(tpos), n_times,
        static_cast<const unsigned char*>(mask), static_cast<const float*>(g),
        static_cast<const float*>(n2), static_cast<const TH*>(h),
        static_cast<const float*>(w), static_cast<float*>(dh),
        static_cast<float*>(dw), B, n, rows, cap, n_rels, d);
    if (vec == 4 && d <= kWarp * 4)
      std::apply(bwd<4, 1, TH, kOH>, args);
    else if (vec == 4)
      std::apply(bwd<4, kMaxD / (kWarp * 4), TH, kOH>, args);
    else
      std::apply(bwd<1, kMaxD / kWarp, TH, kOH>, args);
  });
}
