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
// Within a block the tile's operands sit in shared memory; each thread owns
// one column and eight rows, so every weight element is read once per block
// (coalesced across the warp) and every shared operand is a warp-wide
// broadcast. The SpMMs and their transposes give one warp per row over a
// CSR of that step's edges, summing in registers without atomics. Products
// use plain FMA.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTileRows = 16;
constexpr int kRowGroups = 2;                         // threads = 2 * d
constexpr int kRowsPerThread = kTileRows / kRowGroups;
constexpr int kMaxChunks = 8;                         // d <= 256
// Unroll of the GRU gate-product loop: 4 in the one-GRU forward kernels,
// none in the backward ones, which recompute the gates beside their own
// products, nor in the bidirectional forward (two GRUs a tile). Measured on
// an H100 (PERF.md): unrolled, the window forward takes 2.7 ms where it took
// 3.5 (86 -> 126 registers); the window backward 17 ms where it took 14.4
// (80 -> 130 registers) and the bidirectional forward 4.7 where it took 3.0
// (96 -> 130): above 128 registers a 256-thread block leaves no room for a
// second one on an SM.
constexpr int kUnrolled = 4;  // window_layer_kernel, final_layer_kernel
constexpr int kRolled = 1;    // the backward tiles, bi_layer_kernel

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
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
                        // layer's output buffer; the final step: history)
  int L1, A, d, k;
};

// The row of prev that holds row `row`'s previous state, and its liveness.
__device__ __forceinline__ long long prev_row(const Layer& p,
                                              long long elem_row,
                                              long long row) {
  return p.gidx != nullptr ? elem_row + p.gidx[row] : row;
}

__device__ __forceinline__ float live_of(const Layer& p, long long row) {
  return p.live != nullptr ? p.live[row] : 1.f;
}

// The gates of the rows r0..r0+7 a thread owns, at its column.
struct Gates {
  float r[kRowsPerThread], z[kRowsPerThread], n[kRowsPerThread];
  float ghn[kRowsPerThread];  // W_hn h + b_hn, before the reset gate
};

// Rows a0..a0+15 of element b into shared memory: xs = the input rows, hs =
// the previous states times live * exp(-lambda * dt) (cs = xs when the conv
// output is given). No barrier at the end.
__device__ __forceinline__ void load_tile(const Layer& p, int b, int a0,
                                          float* xs, float* cs, float* hs) {
  const int d = p.d, A = p.A;
  const long long elem_row = (long long)b * p.L1 * A;
  const long long step_row = elem_row + (long long)p.k * A;
  for (int i = threadIdx.x; i < kTileRows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int a = a0 + r;
    float xv = 0.f, hv = 0.f;
    if (a < A) {
      const long long row = step_row + a;
      xv = p.x[row * d + c];
      const float dec = expf(-p.lam * p.dt[row]);
      hv = p.prev[prev_row(p, elem_row, row) * d + c] * live_of(p, row) * dec;
    }
    xs[i] = xv;
    if (hs != nullptr) hs[i] = hv;
    if (p.conv_given) cs[i] = xv;
  }
}

// The decayed previous states of a tile only (the second direction of a
// bidirectional layer, whose input rows are already loaded).
__device__ __forceinline__ void load_prev(const Layer& p, int b, int a0,
                                          float* hs) {
  const int d = p.d, A = p.A;
  const long long elem_row = (long long)b * p.L1 * A;
  const long long step_row = elem_row + (long long)p.k * A;
  for (int i = threadIdx.x; i < kTileRows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int a = a0 + r;
    float hv = 0.f;
    if (a < A) {
      const long long row = step_row + a;
      const float dec = expf(-p.lam * p.dt[row]);
      hv = p.prev[prev_row(p, elem_row, row) * d + c] * live_of(p, row) * dec;
    }
    hs[i] = hv;
  }
}

// The conv output of a loaded tile into cs: the relational SpMM with double
// degree normalization (one warp a row) plus the self-loop product times its
// dropout mask, then the ReLU when p.relu. Writes norm^2 of each row to
// n2_out when it is not null. Starts and ends with a barrier.
__device__ __forceinline__ void conv_tile(const Layer& p, int b, int a0,
                                          const float* xs, float* cs,
                                          float* n2_out) {
  const int d = p.d, A = p.A;
  const long long step_row = ((long long)b * p.L1 + p.k) * A;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  __syncthreads();
  if (p.conv_given) return;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int nwarps = (nthreads + kWarp - 1) / kWarp;
  for (int r = warp; r < kTileRows; r += nwarps) {
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
      if (c < d) cs[r * d + c] = acc[j] * n2;
    }
    if (n2_out != nullptr && lane == 0 && a < A) n2_out[step_row + a] = n2;
  }
  __syncthreads();

  const int col = tid % d;
  const int r0 = (tid / d) * kRowsPerThread;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int kk = 0; kk < d; ++kk) {
    const float w = p.loopw[kk * d + col];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      acc[i] += xs[(r0 + i) * d + kk] * w;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int a = a0 + r0 + i;
    if (p.mask != nullptr && a < A)
      acc[i] *= p.mask[(step_row + a) * d + col];
    const float v = cs[(r0 + i) * d + col] + acc[i];
    cs[(r0 + i) * d + col] = p.relu ? fmaxf(v, 0.f) : v;
  }
  __syncthreads();
}

// The GRU gates at column `col` of the rows r0..r0+7 a thread owns, from the
// input rows cs and the decayed states hs (both in shared memory); the loop
// over the input columns unrolled kUnroll times.
template <int kUnroll>
__device__ __forceinline__ void gru_gates(const float* cs, const float* hs,
                                          const float* __restrict__ wih_t,
                                          const float* __restrict__ whh_t,
                                          const float* __restrict__ bih,
                                          const float* __restrict__ bhh,
                                          int d, Gates& gt) {
  const int col = threadIdx.x % d;
  const int r0 = (threadIdx.x / d) * kRowsPerThread;
  float gir[kRowsPerThread], giz[kRowsPerThread], gin[kRowsPerThread];
  float ghr[kRowsPerThread], ghz[kRowsPerThread], ghn[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    gir[i] = giz[i] = gin[i] = 0.f;
    ghr[i] = ghz[i] = ghn[i] = 0.f;
  }
  const int d3 = 3 * d;
#pragma unroll (kUnroll)
  for (int kk = 0; kk < d; ++kk) {
    const float* wi = wih_t + (long long)kk * d3;
    const float* wh = whh_t + (long long)kk * d3;
    const float wir = wi[col], wiz = wi[d + col], win = wi[2 * d + col];
    const float whr = wh[col], whz = wh[d + col], whn = wh[2 * d + col];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float cv = cs[(r0 + i) * d + kk];
      const float hv = hs[(r0 + i) * d + kk];
      gir[i] += cv * wir;
      giz[i] += cv * wiz;
      gin[i] += cv * win;
      ghr[i] += hv * whr;
      ghz[i] += hv * whz;
      ghn[i] += hv * whn;
    }
  }
  const float bir = bih[col], biz = bih[d + col], bin = bih[2 * d + col];
  const float bhr = bhh[col], bhz = bhh[d + col], bhn = bhh[2 * d + col];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    gt.r[i] = sigmoid((gir[i] + bir) + (ghr[i] + bhr));
    gt.z[i] = sigmoid((giz[i] + biz) + (ghz[i] + bhz));
    gt.ghn[i] = ghn[i] + bhn;
    gt.n[i] = tanhf((gin[i] + bin) + gt.r[i] * gt.ghn[i]);
  }
}

// The forward of one layer for rows a0..a0+15 of element b, up to the GRU
// gates: xs = the input rows, hs = the decayed previous states, cs = the
// conv output. Writes norm^2 of each row to n2_out when it is not null.
template <int kUnroll>
__device__ __forceinline__ void layer_tile(const Layer& p, int b, int a0,
                                           float* xs, float* cs, float* hs,
                                           float* n2_out, Gates& gt) {
  load_tile(p, b, a0, xs, cs, hs);
  conv_tile(p, b, a0, xs, cs, n2_out);
  gru_gates<kUnroll>(cs, hs, p.wih_t, p.whh_t, p.bih, p.bhh, p.d, gt);
}

// Backward of one layer's GRU at step k for a tile of rows (blockIdx.x) of
// element blockIdx.y: recomputes the conv output and the gates, takes d_out
// from db, and gives d_conv (plus the cotangent g_loc of the conv output
// itself when it is not null, both through the ReLU's mask when p.relu; and
// d_conv * mask, the self-loop cotangent) into the step scratch, the gate
// cotangents and their product operands into the step scratch for the
// weight launch. The cotangent of each row's
// previous state goes to dprev at the row itself when dprev is not null
// (the final step: d_hist), else it is added into db at the row gidx names
// (the window; dead rows add nothing). Shared memory: 7 * kTileRows * d.
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
  const int d = p.d, A = p.A, d3 = 3 * d, d4 = 4 * d;
  float* xs = smem;
  float* cs = xs + kTileRows * d;
  float* hs = cs + kTileRows * d;
  float* dg = hs + kTileRows * d;      // [kTileRows, 4d]: d_r, d_z, d_n, d_ghn
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kTileRows;
  Gates gt;
  layer_tile<kRolled>(p, b, a0, xs, cs, hs, n2_out, gt);

  const int col = threadIdx.x % d;
  const int r0 = (threadIdx.x / d) * kRowsPerThread;
  const long long elem_row = (long long)b * p.L1 * A;
  const long long step_row = elem_row + (long long)p.k * A;
  float dh_direct[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = r0 + i, a = a0 + r;
    float pr = 0.f, pz = 0.f, pn = 0.f, phn = 0.f;
    dh_direct[i] = 0.f;
    if (a < A) {
      const long long row = step_row + a;
      const long long m = (long long)b * A + a;
      const float dout = db[row * d + col];
      const float h = hs[r * d + col];
      const float z = gt.z[i], n = gt.n[i], rg = gt.r[i];
      const float dz = dout * (h - n);
      const float dn = dout * (1.f - z);
      dh_direct[i] = dout * z;
      pn = dn * (1.f - n * n);
      phn = pn * rg;
      const float dr = pn * gt.ghn[i];
      pr = dr * rg * (1.f - rg);
      pz = dz * z * (1.f - z);
      conv_s[m * d + col] = cs[r * d + col];
      h0g_s[m * d + col] = h;
      dgi_s[m * d3 + col] = pr;
      dgi_s[m * d3 + d + col] = pz;
      dgi_s[m * d3 + 2 * d + col] = pn;
      dgh_s[m * d3 + col] = pr;
      dgh_s[m * d3 + d + col] = pz;
      dgh_s[m * d3 + 2 * d + col] = phn;
    }
    dg[r * d4 + col] = pr;
    dg[r * d4 + d + col] = pz;
    dg[r * d4 + 2 * d + col] = pn;
    dg[r * d4 + 3 * d + col] = phn;
  }
  __syncthreads();

  // d_conv = d_gi @ W_ih and d_h0g += d_gh @ W_hh, column `col`
  float dx[kRowsPerThread], dh[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) dx[i] = dh[i] = 0.f;
  for (int j = 0; j < d; ++j) {
    const float wr = wih[(long long)j * d + col];
    const float wz = wih[(long long)(d + j) * d + col];
    const float wn = wih[(long long)(2 * d + j) * d + col];
    const float ur = whh[(long long)j * d + col];
    const float uz = whh[(long long)(d + j) * d + col];
    const float un = whh[(long long)(2 * d + j) * d + col];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float* g = dg + (r0 + i) * d4;
      dx[i] += g[j] * wr + g[d + j] * wz + g[2 * d + j] * wn;
      dh[i] += g[j] * ur + g[d + j] * uz + g[3 * d + j] * un;
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int a = a0 + r0 + i;
    if (a >= A) continue;
    const long long row = step_row + a;
    const long long m = (long long)b * A + a;
    float dc = dx[i];
    if (g_loc != nullptr) dc += g_loc[row * d + col];
    if (p.relu && !(cs[(r0 + i) * d + col] > 0.f)) dc = 0.f;
    dconv_s[m * d + col] = dc;
    dlp_s[m * d + col] = p.mask != nullptr ? dc * p.mask[row * d + col] : dc;
    const float lv = live_of(p, row);
    const float dec = expf(-p.lam * p.dt[row]);
    if (dprev != nullptr) {
      dprev[row * d + col] = (dh_direct[i] + dh[i]) * dec * lv;
    } else if (lv != 0.f) {
      const long long t = prev_row(p, elem_row, row) * d + col;
      db[t] += (dh_direct[i] + dh[i]) * dec * lv;
    }
  }
}

// Cotangent of one layer's input rows at step k, for a tile of rows
// (blockIdx.x) of element blockIdx.y: out = (base + SpMM^T of d_conv) +
// d_lp @ loop^T, with base the current out (accumulate) or 0. Also writes
// each edge's relation-weight cotangent (over a CSR by source, so every
// unmasked edge of the step is written once; masked edges are in no CSR and
// their slots are never read). Shared memory: 2 * kTileRows * d.
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
  float* ls = smem;                    // [kTileRows, d] d_lp rows
  float* cs = ls + kTileRows * d;      // [kTileRows, d] SpMM^T rows
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kTileRows;
  const long long step_row = ((long long)b * L1 + k) * A;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int i = tid; i < kTileRows * d; i += nthreads) {
    const int r = i / d, c = i - r * d;
    const int a = a0 + r;
    ls[i] = a < A ? dlp_s[((long long)b * A + a) * d + c] : 0.f;
  }
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int nwarps = (nthreads + kWarp - 1) / kWarp;
  for (int r = warp; r < kTileRows; r += nwarps) {
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
      if (c < d) cs[r * d + c] = acc[j];
    }
  }
  __syncthreads();

  const int col = tid % d;
  const int r0 = (tid / d) * kRowsPerThread;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int j = 0; j < d; ++j) {
    const float w = loop_t[j * d + col];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] += ls[(r0 + i) * d + j] * w;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int a = a0 + r0 + i;
    if (a >= A) continue;
    float* o = out + (step_row + a) * d + col;
    const float base = accumulate ? *o : 0.f;
    *o = (base + cs[(r0 + i) * d + col]) + acc[i];
  }
}

// Weight cotangents: out[x_col, g_col] += sum over B*A rows of
// X[row, x_col] * G[row, g_col], and bias[g_col] += sum of G. The rows are
// cut into ranges (blockIdx.y); each range adds into its own copy of the
// outputs (part + range * part_stride), so no two blocks write one address,
// and a reduction sums the copies in range order: deterministic sums.
// blockIdx.x walks the output tiles of up to kWgJobs jobs.
constexpr int kWgX = 32;      // x columns per tile (16 threads x 2)
constexpr int kWgG = 64;      // g columns per tile (16 threads x 4)
constexpr int kWgRows = 32;   // rows per shared-memory chunk
constexpr int kWgThreads = 256;
constexpr int kWgJobs = 6;
constexpr int kNoJob = 0x7fffffff;  // `first` of an unused job slot

struct WJob {
  const float* x;      // row (b, a) at x + b * x_es + a * nx
  long long x_es;
  const float* g;      // row (b, a) at g + b * g_es + a * ng
  long long g_es;
  float* out;          // [nx, ng] in range 0's copy
  float* bias;         // [ng] or null; then X has a column of ones at nx
  int nx, ng, tiles_g, first;
};

struct WJobs {
  WJob job[kWgJobs];
};

__device__ __forceinline__ void wgrad_tile(const WJobs& jobs, int B, int A,
                                           int rows_per_split,
                                           long long part_stride) {
  __shared__ float xsm[kWgRows][kWgX];
  __shared__ float gsm[kWgRows][kWgG];
  int j = 0;
  while (j + 1 < kWgJobs && (int)blockIdx.x >= jobs.job[j + 1].first) ++j;
  const WJob jb = jobs.job[j];
  const int t = blockIdx.x - jb.first;
  const int tx0 = (t / jb.tiles_g) * kWgX;
  const int tg0 = (t % jb.tiles_g) * kWgG;
  const int tid = threadIdx.x;
  const int tx = tid / 16, tg = tid % 16;
  const int m_begin = blockIdx.y * rows_per_split;
  const int m_end = min(B * A, m_begin + rows_per_split);
  float acc[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kWgRows) {
    for (int i = tid; i < kWgRows * kWgX; i += kWgThreads) {
      const int r = i / kWgX, c = i % kWgX;
      const int m = m0 + r, xc = tx0 + c;
      float v = 0.f;
      if (m < m_end) {
        if (xc < jb.nx) {
          const int b = m / A, a = m - b * A;
          v = jb.x[b * jb.x_es + (long long)a * jb.nx + xc];
        } else if (xc == jb.nx && jb.bias != nullptr) {
          v = 1.f;
        }
      }
      xsm[r][c] = v;
    }
    for (int i = tid; i < kWgRows * kWgG; i += kWgThreads) {
      const int r = i / kWgG, c = i % kWgG;
      const int m = m0 + r, gc = tg0 + c;
      float v = 0.f;
      if (m < m_end && gc < jb.ng) {
        const int b = m / A, a = m - b * A;
        v = jb.g[b * jb.g_es + (long long)a * jb.ng + gc];
      }
      gsm[r][c] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kWgRows; ++r) {
      const float xa = xsm[r][tx], xb = xsm[r][tx + 16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float gv = gsm[r][tg + 16 * q];
        acc[0][q] += xa * gv;
        acc[1][q] += xb * gv;
      }
    }
    __syncthreads();
  }
  const long long off = (long long)blockIdx.y * part_stride;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int xc = tx0 + tx + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gc = tg0 + tg + 16 * q;
      if (gc >= jb.ng) continue;
      if (xc < jb.nx)
        jb.out[off + (long long)xc * jb.ng + gc] += acc[p][q];
      else if (xc == jb.nx && jb.bias != nullptr)
        jb.bias[off + gc] += acc[p][q];
    }
  }
}

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
  return (per + kWgRows - 1) / kWgRows * kWgRows;
}

Layer make_layer(const void* x, int conv_given, const void* rowptr,
                 const void* src, const void* rel, const void* em,
                 const void* wrel, int wstride, int wcol, const void* loopw,
                 const void* mask, int relu, const void* wih_t,
                 const void* whh_t,
                 const void* bih, const void* bhh, const void* gidx,
                 const void* live, const void* dt, float lam,
                 const void* prev, int L1, int A, int d, int k) {
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
  return p;
}

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
  jb.tiles_g = (ng + kWgG - 1) / kWgG;
  jb.first = *first;
  const int tiles_x = (nx + (bias != nullptr ? 1 : 0) + kWgX - 1) / kWgX;
  *first += tiles_x * jb.tiles_g;
  return jb;
}

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
