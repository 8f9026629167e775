// K13 and K13b in their bfloat16 mode. Replaces the bfloat16
// instantiation of temp_tpu/parallel/ring_pallas.py:_ring_kernel and of
// its backward _ring_spmm_bwd.
//
// Two routes, both here:
//
// - The stepped route: ring_spmm.cu compiled with TK_BF16 1 (ring_spmm.cu
//   says what the mode computes), its launchers exported with the suffix
//   _bf16. The wrapper rounds h to bfloat16 once and carries the shards
//   round the ring by copies between the steps' slots: m launches and
//   m - 1 copies a forward call, m + 2 launches and m - 1 copies a
//   backward one. It serves ranks that sit on more than one card.
//
// - The whole-card route (ring_bf16_fwd_launch, ring_bf16_bwd_launch):
//   every rank of the ring on one card, the controller's, so every shard
//   already lies in the same memory. One pass a call reads them in place:
//   one launch a forward call and one a backward call, no rotation copy
//   and no bfloat16 copy of h. Its sums run in the stepped route's order,
//   so at s = 1 its outputs are those of the stepped kernels bit for bit.
//
// Forward (ring_card_fwd_kernel): one warp owns one (graph b, global row
// g = r * rows + row of rank r). For k = 0 .. m - 1 it takes owner =
// (r + k) % m, as the stepped kernel's step k does, and walks the owner
// segment of rank r's fwd table (RingTables, the forward's ordering); each
// step's sum starts from 0 in table order and is added to the running
// total in step order, and the total is scaled by norm^2 at the end. The
// degree is the count of kept edges over the m segments, which the walk
// visits all. The source row is gathered straight from the controller's
// float32 h at its global row (the table's src): each lane loads its
// four columns as one 16-byte load (d = 128) and rounds them in registers
// (rounding once equals rounding at each read: the stepped route's bf16
// copy holds the same values); each relation weight is rounded as read.
//
// Backward (ring_card_bwd_kernel), one launch with two roles:
// - dw warps, first: one warp owns one (relation, chunk of columns). It
//   goes over the ranks in order and forms each rank's partial over the B
//   graphs in order and that relation's edges in table order, then adds it
//   to the total: ring_dw_kernel's partials and ring_dw_reduce_kernel's sum
//   in one pass, in their order. h is read as float32 and rounded in
//   registers, the cotangents are not rounded.
// - dh warps: one warp owns one (graph b, shard q, row v). For k = 0 ..
//   m - 1 it walks the src table segment q * rows + v of rank (q + 1 + k)
//   % m, the rank that holds shard q's accumulator at the stepped route's
//   step k; each step's partial starts from 0 and is added to the total in
//   that order, as the accumulators going round the ring add them.
//
// The dw warps come first so that the longest relations start first.
//
// What bounds it on an H100: memory and latency. A call moves well under
// a megabyte (the referenced rows of h, g and w, the tables, the outputs)
// and does a few flops a byte; most rows have few or no edges, so each
// warp's time is its chain of table, mask and row loads. What the design
// does about that: one launch, so the host makes one ctypes call; the
// lanes load the row pointers of all m segments at once and 32 edges'
// triples and mask bytes at once, __ballot_sync picks the kept edges and
// __shfl_sync broadcasts each, and the rows of kAhead kept edges are in
// flight before they are summed. No atomics and no block waits on
// another: runs repeat bit for bit; rows without edges come out 0.
#define TK_BF16 1
#define ring_fwd_step_launch ring_fwd_step_launch_bf16
#define ring_bwd_step_launch ring_bwd_step_launch_bf16
#define ring_dw_launch ring_dw_launch_bf16
#include "ring_spmm.cu"

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAhead = 2;  // kept edges whose rows a warp loads at once

// V float32 values a lane (one 16-byte load for V = 4), each rounded to
// bfloat16 when kRound
template <int V, bool kRound>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
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
  if constexpr (kRound) {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = hot(x[i]);
  }
}

// The row pointer's entries [key, key + 1] of block `blk` of the table
// for each of the n <= 32 blocks, loaded at once: lane i holds block i's.
// blk(i) gives block i's index into the tables.
struct Seg {
  int lo, hi;
};

template <typename F>
__device__ __forceinline__ Seg lane_seg(const int* __restrict__ ptr,
                                        int n_keys, int key, int lane, int n,
                                        F blk) {
  Seg s{0, 0};
  if (n <= kWarp && lane < n) {
    const int* p = ptr + blk(lane) * (n_keys + 1) + key;
    s.lo = p[0];
    s.hi = p[1];
  }
  return s;
}

// Segment i of a warp's n blocks: from the lanes' loads where n <= 32,
// else read here.
template <typename F>
__device__ __forceinline__ Seg seg_of(const Seg& mine,
                                      const int* __restrict__ ptr,
                                      int n_keys, int key, int i, int n,
                                      F blk) {
  if (n <= kWarp)
    return {__shfl_sync(kFull, mine.lo, i), __shfl_sync(kFull, mine.hi, i)};
  const int* p = ptr + blk(i) * (n_keys + 1) + key;
  return {p[0], p[1]};
}

// The table block (time position of graph b, rank r) as an index of
// [T * m] blocks.
__device__ __forceinline__ long long block_of(const long long* tpos,
                                              long long tpos_stride,
                                              int n_times, int b, int r,
                                              int m) {
  const long long tp = tpos[b * tpos_stride];
  assert(tp >= 0 && tp < n_times);  // a time position outside the tables
  return tp * m + r;
}

// Adds to acc, in table order, the terms of the kept edges of [e0, e1) of
// one block (edges: cap x 3 ints, kept where mask[slot] != 0); returns
// their count. term(x0, x1, av, bv, acc) adds one edge's term given its
// first two ints and the rows av = A[x0], bv = Bm[x1] at the lane's
// columns from col0 (A's values rounded when kRoundA, Bm's when kRoundB;
// a null A or Bm loads nothing, the term reads its own).
template <int V, int C, bool kRoundA, bool kRoundB, typename Term>
__device__ __forceinline__ int walk_block(
    const int* __restrict__ edge, const unsigned char* __restrict__ mask,
    int e0, int e1, int lane, int d, const float* __restrict__ A, const float* __restrict__ Bm, int col0,
    float (&acc)[C][V], Term term) {
  int n_kept = 0;
  for (int base = e0; base < e1; base += kWarp) {
    const int e = base + lane;
    int xa = 0, xb = 0;
    bool keep = false;
    if (e < e1) {
      const int* x = edge + 3LL * e;
      xa = x[0];
      xb = x[1];
      keep = mask[x[2]] != 0;
    }
    unsigned kept = __ballot_sync(kFull, keep);  // the same in every lane
    n_kept += __popc(kept);
    while (kept != 0u) {
      int qa[kAhead], qb[kAhead];
      int n = 0;
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int j = kept != 0u ? __ffs(kept) - 1 : 0;
        qa[q] = __shfl_sync(kFull, xa, j);
        qb[q] = __shfl_sync(kFull, xb, j);
        if (kept != 0u) {
          ++n;
          kept &= kept - 1;
        }
      }
      // the rows of n kept edges in flight, then summed in table order
      float av[kAhead][C][V], bv[kAhead][C][V];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        if (q < n) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int col = col0 + (c * kWarp + lane) * V;
            if (col < d) {
              if (A) load_row<V, kRoundA>(A + (long long)qa[q] * d + col,
                                          av[q][c]);
              if (Bm) load_row<V, kRoundB>(Bm + (long long)qb[q] * d + col,
                                           bv[q][c]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        if (q < n) term(qa[q], qb[q], av[q], bv[q], acc);
    }
  }
  return n_kept;
}

template <int V, int C>
__device__ __forceinline__ void zero(float (&x)[C][V]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) x[c][i] = 0.f;
}

template <int V, int C>
__device__ __forceinline__ void add_to(float (&tot)[C][V],
                                       const float (&x)[C][V]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) tot[c][i] = tot[c][i] + x[c][i];
}

template <int V, int C>
__device__ __forceinline__ void store_row(float* __restrict__ o,
                                          const float (&x)[C][V], int lane,
                                          int d, int col0, float scale) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = col0 + (c * kWarp + lane) * V;
    if (col < d) {
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(o + col) =
            make_float4(x[c][0] * scale, x[c][1] * scale, x[c][2] * scale,
                        x[c][3] * scale);
      else
        o[col] = x[c][0] * scale;
    }
  }
}

// A lane holds C chunks of V columns: V = 4 (s = 1, d % 4 == 0, rows
// 16-byte aligned; C = 1 for d <= 128, 2 for d <= 256) or V = 1 (C = 8).
template <int V, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ring_card_fwd_kernel(const int* __restrict__ ptr, const int* __restrict__ edge,
                     const long long* __restrict__ tpos,
                     long long tpos_stride, int n_times,
                     const unsigned char* __restrict__ mask,
                     long long mask_stride, const float* __restrict__ h,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ n2_out, int B, int m, int rows,
                     int cap, int d, int s) {
  const int lane = threadIdx.x % kWarp;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int M = m * rows;
  if (warp >= (long long)B * M) return;
  const int g = warp % M;
  const int b = warp / M;
  const int r = g / rows, row = g % rows;
  const long long blk = block_of(tpos, tpos_stride, n_times, b, r, m);
  const int* bp = ptr + blk * (M + 1);
  const int* be = edge + blk * cap * 3;
  const unsigned char* bm = mask + b * mask_stride;
  // owner q's segment of rank r's block, keys q * rows + row: lane q
  // loads q's where m <= 32
  Seg mine{0, 0};
  if (m <= kWarp && lane < m) {
    mine.lo = bp[lane * rows + row];
    mine.hi = bp[lane * rows + row + 1];
  }
  const float* hb = h + (long long)b * M * d;
  const int wlen = d * s;
  float tot[C][V], acc[C][V];
  zero(tot);
  int deg = 0;
  for (int k = 0; k < m; ++k) {
    const int owner = (r + k) % m;
    Seg sg;
    if (m <= kWarp)
      sg = {__shfl_sync(kFull, mine.lo, owner),
            __shfl_sync(kFull, mine.hi, owner)};
    else
      sg = {bp[owner * rows + row], bp[owner * rows + row + 1]};
    zero(acc);
    if (s == 1) {
      deg += walk_block<V, C, true, true>(
          be, bm, sg.lo, sg.hi, lane, d, hb, w, 0, acc,
          [&](int, int, const float(&hv)[C][V], const float(&wv)[C][V],
              float(&a)[C][V]) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              if ((c * kWarp + lane) * V < d)
#pragma unroll
                for (int i = 0; i < V; ++i) a[c][i] += hot(hv[c][i] * wv[c][i]);
          });
    } else {
      // column col = blk * s + o sums its block's s inputs:
      // h[blk * s + i] * W[blk, i, o] at weight offset (blk * s + i) * s + o
      deg += walk_block<V, C, false, false>(
          be, bm, sg.lo, sg.hi, lane, d, nullptr, nullptr, 0, acc,
          [&](int xs, int xr, const float(&)[C][V], const float(&)[C][V],
              float(&a)[C][V]) {
            const float* hs = hb + (long long)xs * d;
            const float* wr = w + (long long)xr * wlen;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int col = (c * kWarp + lane) * V;
              if (col < d) {
                const int base = col - col % s, o = col % s;
                float v = 0.f;
                for (int i = 0; i < s; ++i)
                  v += hot(__ldg(hs + base + i)) *
                       hot(__ldg(wr + (base + i) * s + o));
                a[c][0] += hot(v);
              }
            }
          });
    }
    if (k == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) tot[c][i] = acc[c][i];
    } else {
      add_to(tot, acc);
    }
  }
  const float norm = deg > 0 ? 1.f / (float)deg : 0.f;
  const float n2 = norm * norm;
  const long long orow = (long long)b * M + g;
  if (lane == 0) n2_out[orow] = n2;
  store_row(out + orow * d, tot, lane, d, 0, n2);
}

template <int V, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ring_card_bwd_kernel(const int* __restrict__ s_ptr,
                     const int* __restrict__ s_edge,
                     const int* __restrict__ r_ptr,
                     const int* __restrict__ r_edge,
                     const long long* __restrict__ tpos,
                     long long tpos_stride, int n_times,
                     const unsigned char* __restrict__ mask,
                     long long mask_stride, const float* __restrict__ g,
                     const float* __restrict__ n2, const float* __restrict__ h,
                     const float* __restrict__ w, float* __restrict__ dh,
                     float* __restrict__ dw, int B, int m, int rows, int cap,
                     int n_rels, int d, int s) {
  const int lane = threadIdx.x % kWarp;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int M = m * rows;
  const int wlen = d * s;
  constexpr int kChunk = C * kWarp * V;
  const int n_chunk = (wlen + kChunk - 1) / kChunk;
  const long long n_dw = (long long)n_rels * n_chunk;
  if (warp >= n_dw + (long long)B * M) return;
  float tot[C][V], acc[C][V];
  zero(tot);
  if (warp < n_dw) {
    // dw of relation rel, columns [col0, col0 + kChunk): the ranks in
    // order, each one's partial over the B graphs in order
    const int ch = warp % n_chunk;
    const int rel = warp / n_chunk;
    const int col0 = ch * kChunk;
    const int n_blk = m * B;  // block i: rank i / B, graph i % B
    auto blk = [&](int i) {
      return block_of(tpos, tpos_stride, n_times, i % B, i / B, m);
    };
    const Seg mine = lane_seg(r_ptr, n_rels, rel, lane, n_blk, blk);
    for (int r = 0; r < m; ++r) {
      zero(acc);
      for (int b = 0; b < B; ++b) {
        const int i = r * B + b;
        const Seg sg = seg_of(mine, r_ptr, n_rels, rel, i, n_blk, blk);
        const long long gb = (long long)b * M;
        const int* be = r_edge + blk(i) * cap * 3;
        const unsigned char* bm = mask + b * mask_stride;
        // edges (src, dst, slot): h[src] (x) g[dst] * n2[dst]
        if (s == 1) {
          walk_block<V, C, true, false>(
              be, bm, sg.lo, sg.hi, lane, wlen, h + gb * d,
              g + gb * d, col0, acc,
              [&](int, int xd, const float(&hv)[C][V],
                  const float(&gv)[C][V], float(&a)[C][V]) {
                const float sc = __ldg(n2 + gb + xd);
#pragma unroll
                for (int c = 0; c < C; ++c)
                  if (col0 + (c * kWarp + lane) * V < wlen)
#pragma unroll
                    for (int i2 = 0; i2 < V; ++i2)
                      a[c][i2] += hv[c][i2] * (gv[c][i2] * sc);
              });
        } else {
          walk_block<V, C, false, false>(
              be, bm, sg.lo, sg.hi, lane, wlen, nullptr, nullptr,
              col0, acc,
              [&](int xs, int xd, const float(&)[C][V], const float(&)[C][V],
                  float(&a)[C][V]) {
                const float sc = __ldg(n2 + gb + xd);
                const float* gr = g + (gb + xd) * d;
                const float* hr = h + (gb + xs) * d;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  const int wc = col0 + (c * kWarp + lane) * V;
                  if (wc < wlen) {
                    // weight column (blk * s + i) * s + o: input
                    // blk * s + i, output blk * s + o
                    const int cin = wc / s;
                    const int cout = (wc / (s * s)) * s + wc % s;
                    a[c][0] += hot(__ldg(hr + cin)) * (__ldg(gr + cout) * sc);
                  }
                }
              });
        }
      }
      add_to(tot, acc);
    }
    store_row(dw + (long long)rel * wlen, tot, lane, wlen, col0, 1.f);
    return;
  }
  // dh of row v of shard q in graph b: the ranks that hold q's
  // accumulator at steps k = 0 .. m - 1, (q + 1 + k) % m
  const long long i = warp - n_dw;
  const int gr0 = i % M;
  const int b = i / M;
  const int q = gr0 / rows;
  auto blk = [&](int j) {
    return block_of(tpos, tpos_stride, n_times, b, j, m);
  };
  const Seg mine = lane_seg(s_ptr, M, gr0, lane, m, blk);
  const long long gb = (long long)b * M;
  const unsigned char* bm = mask + b * mask_stride;
  for (int k = 0; k < m; ++k) {
    const int r = (q + 1 + k) % m;
    const Seg sg = seg_of(mine, s_ptr, M, gr0, r, m, blk);
    const int* be = s_edge + blk(r) * cap * 3;
    zero(acc);
    // edges (dst, rel, slot): g[dst] * n2[dst] . W[rel]^T
    if (s == 1) {
      walk_block<V, C, false, true>(
          be, bm, sg.lo, sg.hi, lane, d, g + gb * d, w, 0, acc,
          [&](int xd, int, const float(&gv)[C][V], const float(&wv)[C][V],
              float(&a)[C][V]) {
            const float sc = __ldg(n2 + gb + xd);
#pragma unroll
            for (int c = 0; c < C; ++c)
              if ((c * kWarp + lane) * V < d)
#pragma unroll
                for (int i2 = 0; i2 < V; ++i2)
                  a[c][i2] += (gv[c][i2] * sc) * wv[c][i2];
          });
    } else {
      // input column col = blk * s + i sums W[blk, i, o] * dmsg[blk * s + o]
      walk_block<V, C, false, false>(
          be, bm, sg.lo, sg.hi, lane, d, nullptr, nullptr, 0, acc,
          [&](int xd, int xr, const float(&)[C][V], const float(&)[C][V],
              float(&a)[C][V]) {
            const float sc = __ldg(n2 + gb + xd);
            const float* gr = g + (gb + xd) * d;
            const float* wr = w + (long long)xr * wlen;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int col = (c * kWarp + lane) * V;
              if (col < d) {
                const int base = col - col % s;
                float u = 0.f;
                for (int o = 0; o < s; ++o)
                  u += __ldg(wr + col * s + o) * (__ldg(gr + base + o) * sc);
                a[c][0] += u;
              }
            }
          });
    }
    add_to(tot, acc);
  }
  store_row(dh + (gb + gr0) * d, tot, lane, d, 0, 1.f);
}

// Calls f(V, C) with the kernels' lane layout for width d and vec.
template <typename F>
int with_layout(int d, int vec, F&& f) {
  if (vec == 4 && d <= kWarp * 4)
    return f(std::integral_constant<int, 4>{}, std::integral_constant<int, 1>{});
  if (vec == 4)
    return f(std::integral_constant<int, 4>{}, std::integral_constant<int, 2>{});
  return f(std::integral_constant<int, 1>{},
           std::integral_constant<int, kMaxChunks>{});
}

bool layout_ok(int d, int s, int vec) {
  return d > 0 && d <= kChunkCols && s >= 1 && s <= 8 &&
         (vec == 1 || (vec == 4 && s == 1 && d % 4 == 0));
}

// The forward's warps: one a (graph, global row).
long long fwd_warps(int B, int m, int rows) {
  return (long long)B * m * rows;
}

// The backward's warps in lane layout (V, C): the dw warps (a relation and
// a chunk of C * 32 * V weight columns each), then the dh warps (a graph,
// shard and row each).
template <int V, int C>
long long bwd_warps(int B, int m, int rows, int n_rels, int d, int s) {
  constexpr int kChunk = C * kWarp * V;
  const long long n_chunk = ((long long)d * s + kChunk - 1) / kChunk;
  return n_rels * n_chunk + (long long)B * m * rows;
}

}  // namespace

// K13 bf16 on the whole card, one launch a call: tables by source owner and
// local dst (ptr [T, m, m * rows + 1], edge [T, m, cap, 3] of (src, rel,
// slot)), tpos [B] (int64, stride tpos_stride; each in [0, n_times), else a
// device assert stops the kernel), mask [B, m * cap] (bytes, row stride
// mask_stride), h [B, m * rows, d] float32, w [R, d * s] float32, out
// [B, m * rows, d], n2_out [B, m * rows]. vec: 4 (s = 1, d % 4 == 0, h, w
// and out 16-byte aligned) or 1.
extern "C" int ring_bf16_fwd_launch(
    const void* ptr, const void* edge, const void* tpos,
    long long tpos_stride, int n_times, const void* mask,
    long long mask_stride, const void* h, const void* w, void* out,
    void* n2_out, int B, int m, int rows, int cap, int d, int s, int vec,
    void* stream) {
  if (!layout_ok(d, s, vec) || m < 1) return cudaErrorInvalidValue;
  const long long warps = fwd_warps(B, m, rows);
  if (warps == 0) return static_cast<int>(cudaGetLastError());
  return with_layout(d, vec, [&](auto v, auto c) {
    constexpr int V = decltype(v)::value, C = decltype(c)::value;
    ring_card_fwd_kernel<V, C>
        <<<blocks_for(warps), kWarpsPerBlock * kWarp, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(ptr), static_cast<const int*>(edge),
            static_cast<const long long*>(tpos), tpos_stride, n_times,
            static_cast<const unsigned char*>(mask), mask_stride,
            static_cast<const float*>(h), static_cast<const float*>(w),
            static_cast<float*>(out), static_cast<float*>(n2_out), B, m,
            rows, cap, d, s);
    return static_cast<int>(cudaGetLastError());
  });
}

// K13b bf16 on the whole card, one launch a call: tables by source row
// (s_ptr [T, m, m * rows + 1], s_edge [T, m, cap, 3] of (dst, rel, slot))
// and by relation (r_ptr [T, m, n_rels + 1], r_edge of (src, dst, slot)),
// tpos and mask as in the forward, g [B, m * rows, d] and n2 [B, m * rows]
// (the forward's norm^2), h [B, m * rows, d] and w [n_rels, d * s] float32,
// dh like h, dw like w. vec as in the forward (g, h, w, dh, dw aligned).
extern "C" int ring_bf16_bwd_launch(
    const void* s_ptr, const void* s_edge, const void* r_ptr,
    const void* r_edge, const void* tpos, long long tpos_stride, int n_times,
    const void* mask, long long mask_stride, const void* g, const void* n2,
    const void* h, const void* w, void* dh, void* dw, int B, int m,
    int rows, int cap, int n_rels, int d, int s, int vec, void* stream) {
  if (!layout_ok(d, s, vec) || m < 1) return cudaErrorInvalidValue;
  return with_layout(d, vec, [&](auto v, auto c) {
    constexpr int V = decltype(v)::value, C = decltype(c)::value;
    const long long warps = bwd_warps<V, C>(B, m, rows, n_rels, d, s);
    if (warps > 0)
      ring_card_bwd_kernel<V, C>
          <<<blocks_for(warps), kWarpsPerBlock * kWarp, 0,
             static_cast<cudaStream_t>(stream)>>>(
              static_cast<const int*>(s_ptr), static_cast<const int*>(s_edge),
              static_cast<const int*>(r_ptr), static_cast<const int*>(r_edge),
              static_cast<const long long*>(tpos), tpos_stride, n_times,
              static_cast<const unsigned char*>(mask), mask_stride,
              static_cast<const float*>(g), static_cast<const float*>(n2),
              static_cast<const float*>(h), static_cast<const float*>(w),
              static_cast<float*>(dh), static_cast<float*>(dw), B, m, rows,
              cap, n_rels, d, s);
    return static_cast<int>(cudaGetLastError());
  });
}

// The whole-card kernel `which` (0 forward, 1 backward) as its launcher
// launches it for these arguments -> out[5] (a host int[5]): blocks of the
// grid, registers a thread, threads a block, resident blocks an SM, local
// (spill) bytes a thread.
extern "C" int ring_bf16_occupancy(int which, int B, int m, int rows,
                                   int n_rels, int d, int s, int vec,
                                   void* out) {
  if (!layout_ok(d, s, vec) || m < 1) return cudaErrorInvalidValue;
  return with_layout(d, vec, [&](auto v, auto c) {
    constexpr int V = decltype(v)::value, C = decltype(c)::value;
    const void* fn =
        which == 0
            ? reinterpret_cast<const void*>(ring_card_fwd_kernel<V, C>)
            : reinterpret_cast<const void*>(ring_card_bwd_kernel<V, C>);
    const long long warps =
        which == 0 ? fwd_warps(B, m, rows)
                   : bwd_warps<V, C>(B, m, rows, n_rels, d, s);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, kWarpsPerBlock * kWarp, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    int* o = static_cast<int*>(out);
    o[0] = blocks_for(warps);
    o[1] = attr.numRegs;
    o[2] = kWarpsPerBlock * kWarp;
    o[3] = blocks;
    o[4] = static_cast<int>(attr.localSizeBytes);
    return 0;
  });
}
