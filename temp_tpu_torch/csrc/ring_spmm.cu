// Ring-exchanged relational SpMM (K13): one ring step of all the ranks on
// one card, forward and backward, over CSR tables sorted once with the data.
//
// Replaces the TPU kernel temp_tpu/parallel/ring_pallas.py:_ring_kernel
// (grid of m ring steps on each device, an async remote copy of the
// visiting shard overlapped with a one-hot gather / scale / scatter) and
// its backward, which the JAX package computes in XLA ops (_ring_spmm_bwd:
// dmsg at the destinations, dw summed over the ranks, dh carried back to
// the source rows' owners by a reduce-scatter). Here the copies are tensor
// copies between the steps' slots (temp_tpu_torch/parallel/ring_spmm.py)
// and these kernels are the steps. At forward step k rank r holds the shard
// of owner = (r + k) % m in its slot:
//
//     out[b, v] (+)= sum_{e in fwd(t_b, r, owner, v), mask[b, e]}
//                        h_visit[b, src_e - owner * rows] . W[rel_e]
//
// written at step 0, added to after (the shards sum in step order), scaled
// by norm[v]^2 at the last step, norm = 1 / deg, deg the count of the
// mask over v's m owner segments (degrees are local: every edge into v
// sits on v's owner). W[r] is diagonal (s = 1) or block-diagonal with
// s x s blocks (the unpacked weights [R, n_bases * s * s], row length
// d * s). With dmsg_e = g[dst_e] * norm[dst_e]^2 * mask_e the backward is
//
//     dh[u] = sum_{e : src_e = u} dmsg_e . W[rel_e]^T
//     dw[r] = sum_{e : rel_e = r} h[src_e] (x) dmsg_e
//
// dh round the ring: at backward step k rank r holds the accumulator of
// shard q = (r + m - 1 - k) % m, adds its edges whose source lies there
// (the table by source row) and passes it right, so the accumulator ends
// at its owner at step m - 1. dw: per-rank partials by relation (the
// table by relation), regathering h[src] from the controller's h rather
// than keeping an E x d residual, then summed in rank order.
//
// The tables (RingTables, parallel/edge_partition.py) hold each snapshot's
// and rank's edges sorted by (source owner, local dst), by source row and
// by relation, with only the static mask's slots in them; every kernel
// indexes them by its graph's time position t_b and reads the call's mask
// (always a subset) per edge. So a call makes no sort and no host gather:
// one launch a ring step for all ranks of a card.
//
// What bounds it on an H100: memory. Each edge reads one gathered row of d
// floats and its weight row and does 2 s flops a column (4 s in the
// backward), and each output row is written once: far below the card's
// 67 TFLOP/s of f32. The rotation's (m - 1) shards are the ring's own cost.
//
// What the design does about that: one warp owns one (rank, graph, row),
// reads each gathered row as coalesced lines, sums in registers and
// writes the row once a step. No atomics and no block waits on another:
// each row's sum runs in edge order, the steps in step order, the dw
// partials in rank order, so runs repeat bit for bit. Rows without edges
// come out 0.
//
// Compiled a second time as ring_spmm_bf16.cu, with TK_BF16 1: the TPU
// kernel's bfloat16 instantiation (_ring_kernel with dtype_str
// "bfloat16"), whose one-hot products round what they gather. These
// stepped kernels serve the bfloat16 mode only when the ranks sit on more
// than one card: with every rank on the controller's card (one H100) the
// bfloat16 mode takes the whole-card route of ring_spmm_bf16.cu (one launch
// a forward call and one a backward call over the shards where they lie,
// in these kernels' summation order, bit-equal to them at s = 1). The forward
// reads the visiting shards as bfloat16 (the wrapper rounds h once, before
// the ring's copies, so the slots carry half the bytes; rounding once
// equals rounding at each read), rounds each relation weight it reads,
// forms the message in float32 (exact for s = 1: a product of two
// bfloat16 values; s > 1 sums the block's s products in float32) and
// rounds it before the sum, which stays float32; the degrees and norm^2
// stay exact. The backward is the TPU kernel's transpose on its rounded
// residuals: dh's step kernel reads each weight rounded for s = 1 and as
// it is for s > 1 (the transpose reads the unrounded block weights there),
// dw's reads h as bfloat16 (rounded by the wrapper); the cotangents are
// not rounded. The dw reduction is the float32 launcher's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cassert>

#ifndef TK_BF16
#define TK_BF16 0
#endif

namespace {

constexpr bool kBf16 = TK_BF16 != 0;

// h as the kernels read it (the visiting shards, dw's source rows):
// bfloat16 in the bfloat16 mode, float otherwise
#if TK_BF16
typedef __nv_bfloat16 hval;
#else
typedef float hval;
#endif

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x rounded to bfloat16 (to nearest, ties to even, as XLA's convert) in
// the bfloat16 mode, x itself otherwise
__device__ __forceinline__ float hot(float x) {
  if constexpr (kBf16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

constexpr int kWarp = 32;
constexpr int kMaxChunks = 8;  // d <= 256: 8 columns per lane
constexpr int kWarpsPerBlock = 8;
constexpr int kChunkCols = kWarp * kMaxChunks;

// The table block of graph b's snapshot and rank r: rows of its row
// pointer (n_keys + 1 entries) and of its edges (cap x 3 ints).
struct Block {
  const int* ptr;
  const int* edge;
  const unsigned char* mask;
};

__device__ __forceinline__ Block table_block(
    const int* ptr, const int* edge, const long long* tpos,
    long long tpos_stride, int n_times, const unsigned char* mask,
    long long mask_stride, int b, int r, int m, int n_keys, int cap) {
  const long long tp = tpos[b * tpos_stride];
  assert(tp >= 0 && tp < n_times);  // a time position outside the tables
  const long long blk = tp * m + r;
  return {ptr + blk * (n_keys + 1), edge + blk * cap * 3,
          mask + b * mask_stride};
}

__global__ void ring_fwd_step_kernel(
    const int* __restrict__ ptr, const int* __restrict__ edge,
    const long long* __restrict__ tpos, long long tpos_stride, int n_times,
    const unsigned char* __restrict__ mask, long long mask_stride,
    const int* __restrict__ rank_ids, const int* __restrict__ out_ids,
    const hval* __restrict__ h_visit, const float* __restrict__ w,
    float* __restrict__ out, float* __restrict__ n2_out, int B, int nc,
    int n_out, int m, int rows, int cap, int d, int s, int k, int first,
    int last) {
  const int lane = threadIdx.x % kWarp;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= (long long)nc * B * rows) return;
  const int row = warp % rows;
  const int b = (warp / rows) % B;
  const int j = warp / ((long long)rows * B);
  const int r = rank_ids[j];
  const int owner = (r + k) % m;
  const Block t = table_block(ptr, edge, tpos, tpos_stride, n_times, mask,
                              mask_stride, b, r, m, m * rows, cap);
  const int e0 = t.ptr[owner * rows + row], e1 = t.ptr[owner * rows + row + 1];
  const hval* hv = h_visit + ((long long)b * nc + j) * rows * d;
  const int wlen = d * s;
  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int* x = t.edge + 3 * e;
    if (!t.mask[x[2]]) continue;
    const hval* hs = hv + (long long)(x[0] - owner * rows) * d;
    const float* wr = w + (long long)x[1] * wlen;
    if (s == 1) {
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = lane + c * kWarp;
        if (col < d) acc[c] += hot(ld(hs + col) * hot(wr[col]));
      }
    } else {
      // column col = blk * s + o sums its block's s inputs:
      // h[blk * s + i] * W[blk, i, o] at weight offset (blk * s + i) * s + o
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = lane + c * kWarp;
        if (col < d) {
          const int base = col - col % s, o = col % s;
          float v = 0.f;
          for (int i = 0; i < s; ++i)
            v += ld(hs + base + i) * hot(wr[(base + i) * s + o]);
          acc[c] += hot(v);
        }
      }
    }
  }
  const long long orow = ((long long)b * n_out + out_ids[j]) * rows + row;
  float* o = out + orow * d;
  float n2 = 1.f;
  if (last) {
    int deg = 0;  // the mask over the row's m owner segments
    for (int q = 0; q < m; ++q) {
      const int q0 = t.ptr[q * rows + row], q1 = t.ptr[q * rows + row + 1];
      for (int e = q0; e < q1; ++e) deg += t.mask[t.edge[3 * e + 2]] != 0;
    }
    const float norm = deg > 0 ? 1.f / (float)deg : 0.f;
    n2 = norm * norm;
    if (lane == 0) n2_out[orow] = n2;
  }
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = lane + c * kWarp;
    if (col < d) o[col] = (first ? acc[c] : o[col] + acc[c]) * n2;
  }
}

// Backward step k: the accumulator of shard q = (r + m - 1 - k) % m at
// rank r gains dmsg_e . W[rel_e]^T of the rank's edges whose source is its
// row v; g and n2 are the full [B, m * rows] rows (the rank reads its own).
__global__ void ring_bwd_step_kernel(
    const int* __restrict__ ptr, const int* __restrict__ edge,
    const long long* __restrict__ tpos, long long tpos_stride, int n_times,
    const unsigned char* __restrict__ mask, long long mask_stride,
    const int* __restrict__ rank_ids, const int* __restrict__ out_ids,
    const float* __restrict__ g, const float* __restrict__ n2,
    const float* __restrict__ w, const float* __restrict__ acc_in,
    float* __restrict__ acc_out, int B, int nc, int n_out, int m, int rows,
    int cap, int d, int s, int k) {
  const int lane = threadIdx.x % kWarp;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= (long long)nc * B * rows) return;
  const int v = warp % rows;
  const int b = (warp / rows) % B;
  const int j = warp / ((long long)rows * B);
  const int r = rank_ids[j];
  const int q = (r + m - 1 - k) % m;
  const Block t = table_block(ptr, edge, tpos, tpos_stride, n_times, mask,
                              mask_stride, b, r, m, m * rows, cap);
  const int e0 = t.ptr[q * rows + v], e1 = t.ptr[q * rows + v + 1];
  const long long grow0 = (long long)b * m * rows;
  const int wlen = d * s;
  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int* x = t.edge + 3 * e;
    if (!t.mask[x[2]]) continue;
    const float sc = n2[grow0 + x[0]];
    const float* gr = g + (grow0 + x[0]) * d;
    const float* wr = w + (long long)x[1] * wlen;
    if (s == 1) {
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = lane + c * kWarp;
        if (col < d) acc[c] += (gr[col] * sc) * hot(wr[col]);
      }
    } else {
      // input column col = blk * s + i sums W[blk, i, o] * dmsg[blk * s + o]
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = lane + c * kWarp;
        if (col < d) {
          const int base = col - col % s;
          float u = 0.f;
          for (int o = 0; o < s; ++o)
            u += wr[col * s + o] * (gr[base + o] * sc);
          acc[c] += u;
        }
      }
    }
  }
  const int ob = out_ids ? out_ids[j] : j;
  float* o = acc_out + (((long long)b * n_out + ob) * rows + v) * d;
  const float* a =
      acc_in ? acc_in + (((long long)b * nc + j) * rows + v) * d : nullptr;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = lane + c * kWarp;
    if (col < d) o[col] = (a ? a[col] : 0.f) + acc[c];
  }
}

// dw partial of rank r: one warp a (rank, relation, chunk of 256 weight
// columns), over the B graphs in order and each one's edges of the
// relation in table order.
__global__ void ring_dw_kernel(
    const int* __restrict__ ptr, const int* __restrict__ edge,
    const long long* __restrict__ tpos, long long tpos_stride, int n_times,
    const unsigned char* __restrict__ mask, long long mask_stride,
    const int* __restrict__ rank_ids, const int* __restrict__ out_ids,
    const float* __restrict__ g, const float* __restrict__ n2,
    const hval* __restrict__ h, float* __restrict__ part, int B, int nc,
    int m, int rows, int cap, int n_rels, int d, int s) {
  const int lane = threadIdx.x % kWarp;
  const int wlen = d * s;
  const int n_chunk = (wlen + kChunkCols - 1) / kChunkCols;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= (long long)nc * n_rels * n_chunk) return;
  const int ch = warp % n_chunk;
  const int rel = (warp / n_chunk) % n_rels;
  const int j = warp / ((long long)n_chunk * n_rels);
  const int r = rank_ids[j];
  const long long M = (long long)m * rows;
  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;
  for (int b = 0; b < B; ++b) {
    const Block t = table_block(ptr, edge, tpos, tpos_stride, n_times, mask,
                                mask_stride, b, r, m, n_rels, cap);
    const int e0 = t.ptr[rel], e1 = t.ptr[rel + 1];
    for (int e = e0; e < e1; ++e) {
      const int* x = t.edge + 3 * e;
      if (!t.mask[x[2]]) continue;
      const float sc = n2[b * M + x[1]];
      const float* gr = g + (b * M + x[1]) * d;
      const hval* hr = h + (b * M + x[0]) * d;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int wc = ch * kChunkCols + lane + c * kWarp;
        if (wc < wlen) {
          // weight column (blk * s + i) * s + o: input blk * s + i, output
          // blk * s + o
          const int cin = wc / s;
          const int cout = s == 1 ? wc : (wc / (s * s)) * s + wc % s;
          acc[c] += ld(hr + cin) * (gr[cout] * sc);
        }
      }
    }
  }
  float* o = part + ((long long)out_ids[j] * n_rels + rel) * wlen;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int wc = ch * kChunkCols + lane + c * kWarp;
    if (wc < wlen) o[wc] = acc[c];
  }
}

#if !TK_BF16
// dw = the ranks' partials [n_part, total] summed in rank order.
__global__ void ring_dw_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int n_part,
                                      long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int p = 0; p < n_part; ++p) acc += part[p * total + i];
  out[i] = acc;
}
#endif  // !TK_BF16

int blocks_for(long long warps) {
  return static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Forward step k of the nc ranks of one card on `stream`: tables ptr
// [T, m, m * rows + 1] and edge [T, m, cap, 3] (by source owner, local
// dst), tpos [B] (int64, stride tpos_stride; each in [0, n_times), the
// tables' T, else a device assert stops the kernel), mask [B, m * cap]
// (bytes, row stride mask_stride), rank_ids [nc] (each slot's global rank),
// out_ids [nc] (its block of out), h_visit [B, nc, rows, d] (bfloat16 in
// the bfloat16 mode), w [R, d * s],
// out [B, n_out, rows, d] (written at `first`, added to after), n2_out
// [B, n_out, rows] (written at `last`).
extern "C" int ring_fwd_step_launch(
    const void* ptr, const void* edge, const void* tpos,
    long long tpos_stride, int n_times, const void* mask,
    long long mask_stride, const void* rank_ids, const void* out_ids,
    const void* h_visit, const void* w, void* out, void* n2_out, int B,
    int nc, int n_out, int m, int rows, int cap, int d, int s, int k,
    int first, int last, void* stream) {
  const long long warps = (long long)nc * B * rows;
  if (warps > 0) {
    ring_fwd_step_kernel<<<blocks_for(warps), kWarpsPerBlock * kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(edge),
        static_cast<const long long*>(tpos), tpos_stride, n_times,
        static_cast<const unsigned char*>(mask), mask_stride,
        static_cast<const int*>(rank_ids), static_cast<const int*>(out_ids),
        static_cast<const hval*>(h_visit), static_cast<const float*>(w),
        static_cast<float*>(out), static_cast<float*>(n2_out), B, nc, n_out,
        m, rows, cap, d, s, k, first, last);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward step k of the nc ranks of one card: tables by source row
// (ptr [T, m, m * rows + 1], edge [T, m, cap, 3] of (dst, rel, slot)),
// g [B, m * rows, d] and n2 [B, m * rows] (the forward's norm^2), acc_in
// [B, nc, rows, d] (the accumulators received; null at step 0), acc_out
// [B, n_out, rows, d] at block out_ids[j] (null: block j).
extern "C" int ring_bwd_step_launch(
    const void* ptr, const void* edge, const void* tpos,
    long long tpos_stride, int n_times, const void* mask,
    long long mask_stride, const void* rank_ids, const void* out_ids,
    const void* g, const void* n2, const void* w, const void* acc_in,
    void* acc_out, int B, int nc, int n_out, int m, int rows, int cap, int d,
    int s, int k, void* stream) {
  const long long warps = (long long)nc * B * rows;
  if (warps > 0) {
    ring_bwd_step_kernel<<<blocks_for(warps), kWarpsPerBlock * kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(edge),
        static_cast<const long long*>(tpos), tpos_stride, n_times,
        static_cast<const unsigned char*>(mask), mask_stride,
        static_cast<const int*>(rank_ids), static_cast<const int*>(out_ids),
        static_cast<const float*>(g), static_cast<const float*>(n2),
        static_cast<const float*>(w), static_cast<const float*>(acc_in),
        static_cast<float*>(acc_out), B, nc, n_out, m, rows, cap, d, s, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw partials of the nc ranks of one card: tables by relation (ptr
// [T, m, n_rels + 1], edge [T, m, cap, 3] of (src, dst, slot)), g, n2 as
// in the step, h [B, m * rows, d] (bfloat16 in the bfloat16 mode), part
// [*, n_rels, d * s] at row
// out_ids[j].
extern "C" int ring_dw_launch(
    const void* ptr, const void* edge, const void* tpos,
    long long tpos_stride, int n_times, const void* mask,
    long long mask_stride, const void* rank_ids, const void* out_ids,
    const void* g, const void* n2, const void* h, void* part, int B, int nc,
    int m, int rows, int cap, int n_rels, int d, int s, void* stream) {
  const long long n_chunk = (d * s + kChunkCols - 1) / kChunkCols;
  const long long warps = (long long)nc * n_rels * n_chunk;
  if (warps > 0) {
    ring_dw_kernel<<<blocks_for(warps), kWarpsPerBlock * kWarp, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(edge),
        static_cast<const long long*>(tpos), tpos_stride, n_times,
        static_cast<const unsigned char*>(mask), mask_stride,
        static_cast<const int*>(rank_ids), static_cast<const int*>(out_ids),
        static_cast<const float*>(g), static_cast<const float*>(n2),
        static_cast<const hval*>(h), static_cast<float*>(part), B, nc, m,
        rows, cap, n_rels, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

#if !TK_BF16
// dw [total] = sum over p < n_part of part[p, total], in order.
extern "C" int ring_dw_reduce_launch(const void* part, void* out, int n_part,
                                     long long total, void* stream) {
  if (total > 0) {
    const int threads = 256;
    ring_dw_reduce_kernel<<<static_cast<int>((total + threads - 1) / threads),
                            threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part), static_cast<float*>(out), n_part,
        total);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // !TK_BF16
