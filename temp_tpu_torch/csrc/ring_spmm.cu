// Ring-exchanged relational SpMM (K13): one ring step of one rank.
//
// Replaces the TPU kernel temp_tpu/parallel/ring_pallas.py:_ring_kernel
// (grid of m ring steps on each device, an async remote copy of the
// visiting shard overlapped with a one-hot gather / scale / scatter). Here
// the copy is a device-to-device copy on a copy stream, ordered by CUDA
// events (temp_tpu_torch/parallel/ring_spmm.py), and this kernel is the
// aggregation of step k of rank `me`, which holds the shard of
// owner = (me + k) % m in `h_visit`:
//
//     out[b, v] (+)= sum_{e in CSR(b, owner, v)}
//                        h_visit[b, src_e - owner * rows] . W[rel_e]
//
// with out written at step 0, added to at later steps (so the shards sum
// in step order) and scaled by norm[v]^2 at the last step, norm = 1 / deg,
// deg the number of the rank's edges into v over all owners (the lengths
// of v's m CSR rows; degrees are local because every edge into v is on v's
// owner). W[r] is diagonal (s = 1) or block-diagonal with s x s blocks
// (the unpacked weights [R, n_bases * s * s], row length d * s).
//
// What bounds it on an H100: memory. Each edge reads one gathered row of
// d floats and its weight row and does 2 s flops a column, and each
// rank's output is written once: far below the card's 67 TFLOP/s of f32.
// The rotation's (m - 1) shards a rank are the ring's own cost on top,
// not work the function needs.
//
// What the design does about that: the wrapper sorts the rank's edges once
// a call by (graph, source owner, local dst), which gives one CSR for each
// (graph, owner); one warp owns one (graph, local row) and reads each
// gathered row as coalesced lines, sums in registers and writes the row
// once a step. No atomics: each row's sum runs in edge order, the steps in
// step order, so runs repeat bit for bit. Rows without edges come out 0.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChunks = 8;  // d <= 256: 8 columns per lane
constexpr int kWarpsPerBlock = 8;

__global__ void ring_spmm_step_kernel(const int* __restrict__ rowptr,
                                      const int* __restrict__ src,
                                      const int* __restrict__ rel,
                                      const float* __restrict__ h_visit,
                                      const float* __restrict__ w,
                                      float* __restrict__ out,
                                      float* __restrict__ n2_out, int B,
                                      int m, int rows, int d, int s,
                                      int owner, int first, int last) {
  const int lane = threadIdx.x % kWarp;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (warp >= B * rows) return;
  const int b = warp / rows, row = warp % rows;
  const long long seg = ((long long)b * m + owner) * rows + row;
  const int e0 = rowptr[seg], e1 = rowptr[seg + 1];
  const int wlen = d * s;
  float acc[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) acc[j] = 0.f;
  for (int e = e0; e < e1; ++e) {
    const float* hs =
        h_visit + ((long long)b * rows + (src[e] - owner * rows)) * d;
    const float* wr = w + (long long)rel[e] * wlen;
    if (s == 1) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = lane + j * kWarp;
        if (c < d) acc[j] += hs[c] * wr[c];
      }
    } else {
      // column c = blk * s + o sums its block's s inputs:
      // h[blk * s + i] * W[blk, i, o] at weight offset (blk * s + i) * s + o
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = lane + j * kWarp;
        if (c < d) {
          const int base = c - c % s, o = c % s;
          float t = 0.f;
          for (int i = 0; i < s; ++i)
            t += hs[base + i] * wr[(base + i) * s + o];
          acc[j] += t;
        }
      }
    }
  }
  float* o = out + ((long long)b * rows + row) * d;
  float n2 = 1.f;
  if (last) {
    int deg = 0;
    for (int q = 0; q < m; ++q) {
      const long long sq = ((long long)b * m + q) * rows + row;
      deg += rowptr[sq + 1] - rowptr[sq];
    }
    const float norm = deg > 0 ? 1.f / (float)deg : 0.f;
    n2 = norm * norm;
    if (lane == 0) n2_out[(long long)b * rows + row] = n2;
  }
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = lane + j * kWarp;
    if (c < d) o[c] = (first ? acc[j] : o[c] + acc[j]) * n2;
  }
}

}  // namespace

// One ring step of one rank on `stream`: rowptr [B * m * rows + 1], src
// (global ids) and rel sorted by it, h_visit [B, rows, d] (the shard of
// `owner`), w [R, d * s], out [B, rows, d] (written at `first`, added to
// after), n2_out [B, rows] (written at `last`).
extern "C" int ring_spmm_step_launch(const void* rowptr, const void* src,
                                     const void* rel, const void* h_visit,
                                     const void* w, void* out, void* n2_out,
                                     int B, int m, int rows, int d, int s,
                                     int owner, int first, int last,
                                     void* stream) {
  const int warps = B * rows;
  if (warps > 0) {
    const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    ring_spmm_step_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(src),
        static_cast<const int*>(rel), static_cast<const float*>(h_visit),
        static_cast<const float*>(w), static_cast<float*>(out),
        static_cast<float*>(n2_out), B, m, rows, d, s, owner, first, last);
  }
  return static_cast<int>(cudaGetLastError());
}
