// Whole-window GRRGCN history recurrence: forward (K2f), one RGCN+GRU
// layer per launch, and backward (K2b), a few launches per layer and step.
//
// K2f replaces the TPU kernel temp_tpu/ops/fused_window.py:_fwd_kernel
// (reached through fused_window_scan, n_buf=2). For every window step
// k = 0..L1-1 and batch element b, that kernel
//   1. gathers each active row's state from its last active step
//      (gidx/live) and scales it by exp(-lambda * dt);
//   2. layer 1: takes the precomputed conv input (conv1_in, eval) or
//      computes the relational SpMM plus the self-loop product, the latter
//      times the training dropout mask when one is given (no bias, no
//      activation);
//   3. runs a GRU (torch gate order r, z, n) from the decayed state;
//   4. does the same for layer 2 over layer 1's output of step k;
//   5. writes both outputs into the [L1, A, d] buffers.
//
// K2b replaces temp_tpu/ops/fused_window.py:_bwd_kernel. Like it, it keeps
// only the two forward buffers and recomputes every step from them and the
// streamed masks, in reverse step order, giving the cotangents of the
// inputs, the relation weights [R, 2d], both self-loop weights and the GRU
// weights and biases of both layers.
//
// What bounds both on an H100: arithmetic. Per step and element the
// forward does four [A, d] x [d, 3d] GRU gate products and one or two
// [A, d] x [d, d] self-loop products in f32; the backward recomputes them
// and adds two products per forward product (the input and the weight
// cotangents), about three times the forward's work, against a few MB of
// buffers. The SpMM parts are small. So the bound is f32 operations.
//
// What the design does about that. Step k+1 needs every row of step k,
// and layer 2 every row of layer 1's output of the same step; backward
// runs the same chain in reverse. The dependency is carried by the stream:
// the host makes one launch per layer and step forward, and five per step
// backward (layer-2 GRU, layer-2 input cotangent, layer-1 GRU, layer-1
// input cotangent, weight cotangents), each over (row tile, batch element)
// or over (weight tile, row range), and two at the end (the relation and
// the other weight cotangents' sums). No block ever waits for another block. Within a
// block the tile's operands sit in shared memory; each thread owns one
// column and eight rows, so every weight element is read once per block
// (coalesced across the warp) and every shared operand is a warp-wide
// broadcast. The SpMMs and their transposes give one warp per row over a
// CSR of that step's edges (by destination forward, by source backward),
// summing in registers without atomics, as in spmm.cu. The weight
// cotangents are sums over all rows, steps and elements: each step's
// launch gives one block per output tile and range of the step's rows,
// which adds its tile into that range's own copy of the outputs; one last
// launch sums the copies in a fixed order, so the sums are deterministic.
// The relation-weight cotangent is written per edge and summed per
// relation by one last launch over a CSR by relation. The cotangent of a
// row's previous state goes to the row of an earlier step that gidx names;
// a live row names a row no other live row names (each earlier row is read
// only by its entity's next active step), so a plain read-add-store is
// exact, and dead rows (live = 0) store nothing. Products use plain FMA;
// wgmma and TMA are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTileRows = 16;
constexpr int kRowGroups = 2;                         // threads = 2 * d
constexpr int kRowsPerThread = kTileRows / kRowGroups;
constexpr int kMaxChunks = 8;                         // d <= 256

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
  const float* wih_t;   // [d, 3d]
  const float* whh_t;   // [d, 3d]
  const float* bih;     // [3d]
  const float* bhh;     // [3d]
  const int* gidx;      // [B, L1, A] row in the element's [L1*A] buffer
  const float* live;    // [B, L1, A]
  const float* dt;      // [B, L1, A]
  float lam;
  const float* prev;    // [B, L1, A, d] this layer's output buffer
  int L1, A, d, k;
};

// The gates of the rows r0..r0+7 a thread owns, at its column.
struct Gates {
  float r[kRowsPerThread], z[kRowsPerThread], n[kRowsPerThread];
  float ghn[kRowsPerThread];  // W_hn h + b_hn, before the reset gate
};

// The forward of one layer for rows a0..a0+15 of element b, up to the GRU
// gates: xs = the input rows, hs = the decayed previous states, cs = the
// conv output. Writes norm^2 of each row to n2_out when it is not null.
__device__ __forceinline__ void layer_tile(const Layer& p, int b, int a0,
                                           float* xs, float* cs, float* hs,
                                           float* n2_out, Gates& gt) {
  const int d = p.d, A = p.A;
  const long long elem_row = (long long)b * p.L1 * A;
  const long long step_row = elem_row + (long long)p.k * A;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // 1. tile of the input rows and of the decayed previous state
  for (int i = tid; i < kTileRows * d; i += nthreads) {
    const int r = i / d, c = i - r * d;
    const int a = a0 + r;
    float xv = 0.f, hv = 0.f;
    if (a < A) {
      const long long row = step_row + a;
      xv = p.x[row * d + c];
      const float dec = expf(-p.lam * p.dt[row]);
      hv = p.prev[(elem_row + p.gidx[row]) * d + c] * p.live[row] * dec;
    }
    xs[i] = xv;
    hs[i] = hv;
    if (p.conv_given) cs[i] = xv;
  }

  if (!p.conv_given) {
    // 2. relational SpMM with double degree normalization: one warp a row
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
  }
  __syncthreads();

  const int col = tid % d;
  const int r0 = (tid / d) * kRowsPerThread;

  if (!p.conv_given) {
    // 3. self-loop product: conv += (x_tile @ loop) * mask
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
      cs[(r0 + i) * d + col] += acc[i];
    }
    __syncthreads();
  }

  // 4. GRU gate products for column `col` of rows r0..r0+7
  float gir[kRowsPerThread], giz[kRowsPerThread], gin[kRowsPerThread];
  float ghr[kRowsPerThread], ghz[kRowsPerThread], ghn[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    gir[i] = giz[i] = gin[i] = 0.f;
    ghr[i] = ghz[i] = ghn[i] = 0.f;
  }
  const int d3 = 3 * d;
  for (int kk = 0; kk < d; ++kk) {
    const float* wi = p.wih_t + (long long)kk * d3;
    const float* wh = p.whh_t + (long long)kk * d3;
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

  // 5. the gates
  const float bir = p.bih[col], biz = p.bih[d + col], bin = p.bih[2 * d + col];
  const float bhr = p.bhh[col], bhz = p.bhh[d + col], bhn = p.bhh[2 * d + col];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    gt.r[i] = sigmoid((gir[i] + bir) + (ghr[i] + bhr));
    gt.z[i] = sigmoid((giz[i] + biz) + (ghz[i] + bhz));
    gt.ghn[i] = ghn[i] + bhn;
    gt.n[i] = tanhf((gin[i] + bin) + gt.r[i] * gt.ghn[i]);
  }
}

__global__ void window_layer_kernel(Layer p, float* buf) {
  extern __shared__ float smem[];
  const int d = p.d;
  float* xs = smem;                    // [kTileRows, d] input rows
  float* cs = xs + kTileRows * d;      // [kTileRows, d] conv output
  float* hs = cs + kTileRows * d;      // [kTileRows, d] decayed prev state
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kTileRows;
  Gates gt;
  layer_tile(p, b, a0, xs, cs, hs, nullptr, gt);

  const int col = threadIdx.x % d;
  const int r0 = (threadIdx.x / d) * kRowsPerThread;
  const long long step_row = ((long long)b * p.L1 + p.k) * p.A;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int a = a0 + r0 + i;
    if (a < p.A) {
      const float h = hs[(r0 + i) * d + col];
      buf[(step_row + a) * d + col] = (1.f - gt.z[i]) * gt.n[i] + gt.z[i] * h;
    }
  }
}

// Backward of one layer's GRU at step k for a tile of rows: recomputes the
// conv output and the gates, takes d_out from db (this layer's cotangent
// buffer), and gives d_conv (and d_conv * mask, the self-loop cotangent)
// into the step scratch, the gate cotangents and their product operands
// into the step scratch for the weight launch, and adds the cotangent of
// each live row's previous state into db at the row gidx names.
__global__ void window_bwd_gru_kernel(
    Layer p,
    const float* __restrict__ wih,     // [3d, d] (torch layout)
    const float* __restrict__ whh,     // [3d, d]
    float* db,                         // [B, L1, A, d]
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
  layer_tile(p, b, a0, xs, cs, hs, n2_out, gt);

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
    dconv_s[m * d + col] = dx[i];
    dlp_s[m * d + col] = p.mask != nullptr ? dx[i] * p.mask[row * d + col]
                                           : dx[i];
    const float lv = p.live[row];
    if (lv != 0.f) {
      const float dec = expf(-p.lam * p.dt[row]);
      const long long t = (elem_row + p.gidx[row]) * d + col;
      db[t] += (dh_direct[i] + dh[i]) * dec * lv;
    }
  }
}

// Cotangent of one layer's input rows at step k: out = (base + SpMM^T of
// d_conv) + d_lp @ loop^T, with base the current out (accumulate) or 0.
// Also writes each edge's relation-weight cotangent (over a CSR by source,
// so every unmasked edge of the step is written once; masked edges are in
// no CSR and their slots are never read).
__global__ void window_bwd_input_kernel(
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

// Weight cotangents of one step: out[x_col, g_col] += sum over the step's
// B*A rows of X[row, x_col] * G[row, g_col], and bias[g_col] += sum of G.
// The rows are cut into n_split ranges (blockIdx.y); each range adds into
// its own copy of the outputs (part + range * part_stride), so no two
// blocks write one address, and window_wgrad_reduce_kernel sums the copies
// in range order after the last step: deterministic sums.
constexpr int kWgX = 32;      // x columns per tile (16 threads x 2)
constexpr int kWgG = 64;      // g columns per tile (16 threads x 4)
constexpr int kWgRows = 32;   // rows per shared-memory chunk
constexpr int kWgThreads = 256;
constexpr int kWgJobs = 6;

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

__global__ void window_wgrad_kernel(WJobs jobs, int B, int A,
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
__global__ void window_wgrad_reduce_kernel(const float* __restrict__ part,
                                           int n_split, long long total,
                                           float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += part[s * total + i];
  out[i] = acc;
}

// dwrel[r, :d] and dwrel[r, d:] = the per-edge cotangents of layer 1 and
// layer 2 summed over the edges of relation r: one warp a relation.
__global__ void window_rel_grad_kernel(const int* __restrict__ r_ptr,
                                       const int* __restrict__ r_eid,
                                       const float* __restrict__ ewg1,
                                       const float* __restrict__ ewg2,
                                       float* __restrict__ dwrel,
                                       int n_rels, int d) {
  constexpr int kWarpsPerBlock = 8;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (r >= n_rels) return;
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
        a1[j] += ewg1[base + c];
        a2[j] += ewg2[base + c];
      }
    }
  }
  float* o = dwrel + (long long)r * 2 * d;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = lane + j * kWarp;
    if (c < d) {
      o[c] = a1[j];
      o[d + c] = a2[j];
    }
  }
}

Layer make_layer(const void* x, int conv_given, const void* rowptr,
                 const void* src, const void* rel, const void* em,
                 const void* wrel, int wstride, int wcol, const void* loopw,
                 const void* mask, const void* wih_t, const void* whh_t,
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

}  // namespace

extern "C" int window_layer_launch(
    const void* x, int conv_given, const void* rowptr, const void* src,
    const void* rel, const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* gidx,
    const void* live, const void* dt, float lam, void* buf, int B, int L1,
    int A, int d, int k, void* stream) {
  if (B > 0 && A > 0) {
    const Layer p = make_layer(x, conv_given, rowptr, src, rel, em, wrel,
                               wstride, wcol, loopw, mask, wih_t, whh_t, bih,
                               bhh, gidx, live, dt, lam, buf, L1, A, d, k);
    const dim3 grid((A + kTileRows - 1) / kTileRows, B);
    const size_t smem = 3 * kTileRows * d * sizeof(float);
    window_layer_kernel<<<grid, kRowGroups * d, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<float*>(buf));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_bwd_gru_launch(
    const void* x, const void* rowptr, const void* src, const void* rel,
    const void* em, const void* wrel, int wstride, int wcol,
    const void* loopw, const void* mask, const void* wih_t,
    const void* whh_t, const void* bih, const void* bhh, const void* wih,
    const void* whh, const void* gidx, const void* live, const void* dt,
    float lam, const void* prev, void* db, void* n2_out, void* conv_s,
    void* h0g_s, void* dgi_s, void* dgh_s, void* dconv_s, void* dlp_s,
    int B, int L1, int A, int d, int k, void* stream) {
  if (B > 0 && A > 0) {
    const Layer p = make_layer(x, 0, rowptr, src, rel, em, wrel, wstride,
                               wcol, loopw, mask, wih_t, whh_t, bih, bhh,
                               gidx, live, dt, lam, prev, L1, A, d, k);
    const size_t smem = 7 * kTileRows * d * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        window_bwd_gru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((A + kTileRows - 1) / kTileRows, B);
    window_bwd_gru_kernel<<<grid, kRowGroups * d, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const float*>(wih), static_cast<const float*>(whh),
        static_cast<float*>(db), static_cast<float*>(n2_out),
        static_cast<float*>(conv_s), static_cast<float*>(h0g_s),
        static_cast<float*>(dgi_s), static_cast<float*>(dgh_s),
        static_cast<float*>(dconv_s), static_cast<float*>(dlp_s));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_bwd_input_launch(
    const void* s_ptr, const void* s_dst, const void* s_rel,
    const void* s_em, const void* s_eid, const void* n2,
    const void* dconv_s, const void* dlp_s, const void* wrel, int wstride,
    int wcol, const void* loop_t, const void* x, void* ewg, void* out,
    int accumulate, int B, int L1, int A, int d, int k, void* stream) {
  if (B > 0 && A > 0) {
    const dim3 grid((A + kTileRows - 1) / kTileRows, B);
    const size_t smem = 2 * kTileRows * d * sizeof(float);
    window_bwd_input_kernel<<<grid, kRowGroups * d, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(s_ptr), static_cast<const int*>(s_dst),
        static_cast<const int*>(s_rel), static_cast<const float*>(s_em),
        static_cast<const int*>(s_eid), static_cast<const float*>(n2),
        static_cast<const float*>(dconv_s), static_cast<const float*>(dlp_s),
        static_cast<const float*>(wrel), wstride, wcol,
        static_cast<const float*>(loop_t), static_cast<const float*>(x),
        static_cast<float*>(ewg), static_cast<float*>(out), accumulate, L1,
        A, d, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// The six weight jobs of step k: (conv2, d_gi2) -> dwih2 + dbih2,
// (h0g2, d_gh2) -> dwhh2 + dbhh2, (buf1[k], d_lp2) -> dloop2, and the same
// for layer 1 with h0x[k] as the self-loop input. `part` holds n_split
// copies of the flat outputs, each laid out as wih2 [d, 3d], bih2 [3d],
// whh2 [d, 3d], bhh2 [3d], loop2 [d, d], then the same for layer 1.
extern "C" int window_wgrad_launch(
    const void* conv2, const void* h0g2, const void* buf1, const void* dgi2,
    const void* dgh2, const void* dlp2, const void* conv1, const void* h0g1,
    const void* h0x, const void* dgi1, const void* dgh1, const void* dlp1,
    void* part, int n_split, int B, int L1, int A, int d, int k,
    void* stream) {
  if (B > 0 && A > 0 && n_split > 0) {
    const long long sd = (long long)A * d, sg = 3LL * A * d;
    const long long win = (long long)L1 * A * d, off = (long long)k * A * d;
    const float* b1 = static_cast<const float*>(buf1) + off;
    const float* h0 = static_cast<const float*>(h0x) + off;
    const long long dd = (long long)d * d;
    float* o = static_cast<float*>(part);
    float* wih2 = o;
    float* bih2 = wih2 + 3 * dd;
    float* whh2 = bih2 + 3 * d;
    float* bhh2 = whh2 + 3 * dd;
    float* loop2 = bhh2 + 3 * d;
    float* wih1 = loop2 + dd;
    float* bih1 = wih1 + 3 * dd;
    float* whh1 = bih1 + 3 * d;
    float* bhh1 = whh1 + 3 * dd;
    float* loop1 = bhh1 + 3 * d;
    const long long total = (loop1 + dd) - o;
    int first = 0;
    WJobs jobs;
    jobs.job[0] = make_job(conv2, sd, dgi2, sg, wih2, bih2, d, 3 * d, &first);
    jobs.job[1] = make_job(h0g2, sd, dgh2, sg, whh2, bhh2, d, 3 * d, &first);
    jobs.job[2] = make_job(b1, win, dlp2, sd, loop2, nullptr, d, d, &first);
    jobs.job[3] = make_job(conv1, sd, dgi1, sg, wih1, bih1, d, 3 * d, &first);
    jobs.job[4] = make_job(h0g1, sd, dgh1, sg, whh1, bhh1, d, 3 * d, &first);
    jobs.job[5] = make_job(h0, win, dlp1, sd, loop1, nullptr, d, d, &first);
    const int M = B * A;
    const int per = (M + n_split - 1) / n_split;
    const int rows_per_split = (per + kWgRows - 1) / kWgRows * kWgRows;
    window_wgrad_kernel<<<dim3(first, n_split), kWgThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        jobs, B, A, rows_per_split, total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_wgrad_reduce_launch(const void* part, int n_split,
                                          long long total, void* out,
                                          void* stream) {
  if (total > 0) {
    const int threads = 256;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    window_wgrad_reduce_kernel<<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part), n_split, total,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_rel_grad_launch(const void* r_ptr, const void* r_eid,
                                      const void* ewg1, const void* ewg2,
                                      void* dwrel, int n_rels, int d,
                                      void* stream) {
  if (n_rels > 0) {
    const int blocks = (n_rels + 7) / 8;
    window_rel_grad_kernel<<<blocks, 8 * kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(r_ptr), static_cast<const int*>(r_eid),
        static_cast<const float*>(ewg1), static_cast<const float*>(ewg2),
        static_cast<float*>(dwrel), n_rels, d);
  }
  return static_cast<int>(cudaGetLastError());
}
