// Relational SpMM for diagonal relation weights (n_bases == d): forward
// (K1f) and backward (K1b).
//
// K1f replaces the TPU kernel temp_tpu/ops/pallas_spmm.py:_fwd_kernel
// (reached through rel_spmm_pallas). It computes, for every row v,
//
//     out[v] = norm[v]^2 * sum_{e : dst_e = v} h[src_e] * w[rel_e] * em_e
//     norm[v] = 1 / deg[v]  (0 where deg[v] == 0),  deg[v] = sum em_e
//
// which is the reference's double degree normalization, and optionally
// writes norm[v]^2 for the backward pass.
//
// K1b replaces temp_tpu/ops/pallas_spmm.py:_bwd_kernel with _spmm_bwd. With
// g the cotangent of out and dmsg_e = g[dst_e] * norm[dst_e]^2 * em_e:
//
//     dh[u] = sum_{e : src_e = u} dmsg_e * w[rel_e]
//     dw[r] = sum_{e : rel_e = r} dmsg_e * h[src_e]
//
// What bounds both on an H100: memory. Each edge reads one or two gathered
// rows and does 3 flops per column, so the work is the gathered rows plus
// one write of each output, far below the card's 67 TFLOP/s of f32.
//
// What the design does about that: the TPU kernels turned gathers and
// scatters into one-hot matrix products because the MXU was their fast
// path. Here the wrapper sorts the edges once per grouping (a CSR row
// pointer: by destination for K1f; by source and by relation for K1b), and
// one warp owns one output row: the lanes read each gathered row as
// coalesced 128-byte lines, sum into registers and write the row once. No
// atomics, so every result is deterministic and each sum runs in the edge
// order within its row. K1b is one launch: warps below n_rows give dh rows,
// the rest give dw rows.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChunks = 8;       // d <= 256: 8 columns per lane
constexpr int kWarpsPerBlock = 8;

__global__ void spmm_fwd_kernel(const int* __restrict__ rowptr,
                                const int* __restrict__ src,
                                const int* __restrict__ rel,
                                const float* __restrict__ em,
                                const float* __restrict__ h,
                                const float* __restrict__ w,
                                float* __restrict__ out,
                                float* __restrict__ n2_out,  // may be null
                                int n_rows, int d) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  float acc[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) acc[j] = 0.f;
  float deg = 0.f;
  const int e0 = rowptr[row], e1 = rowptr[row + 1];
  for (int e = e0; e < e1; ++e) {
    const float m = em[e];
    deg += m;
    const float* hs = h + (long long)src[e] * d;
    const float* wr = w + (long long)rel[e] * d;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) acc[j] += hs[c] * wr[c] * m;
    }
  }
  const float norm = deg > 0.f ? 1.f / deg : 0.f;
  const float n2 = norm * norm;
  float* o = out + (long long)row * d;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = lane + j * kWarp;
    if (c < d) o[c] = acc[j] * n2;
  }
  if (n2_out != nullptr && lane == 0) n2_out[row] = n2;
}

// One warp per output row. Rows [0, n_rows) are dh over the CSR by source
// (each edge brings its dst, rel, em); rows [n_rows, n_rows + n_rels) are
// dw over the CSR by relation (each edge brings its src, dst, em).
__global__ void spmm_bwd_kernel(const int* __restrict__ s_ptr,
                                const int* __restrict__ s_dst,
                                const int* __restrict__ s_rel,
                                const float* __restrict__ s_em,
                                const int* __restrict__ r_ptr,
                                const int* __restrict__ r_src,
                                const int* __restrict__ r_dst,
                                const float* __restrict__ r_em,
                                const float* __restrict__ g,
                                const float* __restrict__ n2,
                                const float* __restrict__ h,
                                const float* __restrict__ w,
                                float* __restrict__ dh,
                                float* __restrict__ dw,
                                int n_rows, int n_rels, int d) {
  const int lane = threadIdx.x % kWarp;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= n_rows + n_rels) return;
  const bool by_src = warp < n_rows;
  const int row = by_src ? warp : warp - n_rows;
  const int* ptr = by_src ? s_ptr : r_ptr;
  float acc[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) acc[j] = 0.f;
  const int e1 = ptr[row + 1];
  for (int e = ptr[row]; e < e1; ++e) {
    const int t = by_src ? s_dst[e] : r_dst[e];
    const float s = n2[t] * (by_src ? s_em[e] : r_em[e]);
    const float* gt = g + (long long)t * d;
    // the other factor: w[rel_e] for dh, h[src_e] for dw
    const float* f = by_src ? w + (long long)s_rel[e] * d
                            : h + (long long)r_src[e] * d;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) acc[j] += gt[c] * s * f[c];
    }
  }
  float* o = (by_src ? dh : dw) + (long long)row * d;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = lane + j * kWarp;
    if (c < d) o[c] = acc[j];
  }
}

}  // namespace

extern "C" int spmm_fwd_launch(const void* rowptr, const void* src,
                               const void* rel, const void* em, const void* h,
                               const void* w, void* out, void* n2_out,
                               int n_rows, int d, void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    spmm_fwd_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(src),
        static_cast<const int*>(rel), static_cast<const float*>(em),
        static_cast<const float*>(h), static_cast<const float*>(w),
        static_cast<float*>(out), static_cast<float*>(n2_out), n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spmm_bwd_launch(const void* s_ptr, const void* s_dst,
                               const void* s_rel, const void* s_em,
                               const void* r_ptr, const void* r_src,
                               const void* r_dst, const void* r_em,
                               const void* g, const void* n2, const void* h,
                               const void* w, void* dh, void* dw, int n_rows,
                               int n_rels, int d, void* stream) {
  const int warps = n_rows + n_rels;
  if (warps > 0) {
    const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    spmm_bwd_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(s_ptr), static_cast<const int*>(s_dst),
        static_cast<const int*>(s_rel), static_cast<const float*>(s_em),
        static_cast<const int*>(r_ptr), static_cast<const int*>(r_src),
        static_cast<const int*>(r_dst), static_cast<const float*>(r_em),
        static_cast<const float*>(g), static_cast<const float*>(n2),
        static_cast<const float*>(h), static_cast<const float*>(w),
        static_cast<float*>(dh), static_cast<float*>(dw), n_rows, n_rels, d);
  }
  return static_cast<int>(cudaGetLastError());
}
