// csd_spmm_small — the block-sparse junction's forward, backward-data and
// backward-weights for blocks whose bL or bR is not a multiple of 64, on
// Hopper's CUDA cores (sm_90a), f32 accumulation; one junction (E = 1) or
// E expert junctions of one shared pattern.
//
// Replaces, for these block shapes, the TPU kernels of
// repro/kernels/csd_spmm.py: csd_spmm_fwd (#1) and _csd_spmm_fwd_batched
// (#3), csd_spmm_dx (#6) and csd_spmm_dw (#7). The paper's own MLP runs
// blocks of 16 x 4, 4 x 4, 1 x 2 and 2 x 1 (shrink_to_divisor of a 16 cap at
// widths 800, 100, 390, 39), and the LM smoke configurations 16 x 16: below
// the 64-wide tiles of every wgmma/TMA body (csd_spmm_fwd.cu, _dx.cu,
// _dw.cu), and with rows of 39, 100 or 390 elements whose byte strides are
// not multiples of 16, so TMA cannot address them. These forms read global
// memory with 4- and 2-byte loads and compute in f32 on the CUDA cores.
// Plain versions: kernels/csd_spmm.py csd_spmm_{fwd,dx,dw}(_batched)_plain.
//
//   FF  y[m, rb bR + j] = act(sum_f sum_i x[m, blk[rb, f] bL + i] w[rb, f, i, j]
//                             + b[rb bR + j]),  with z the pre-activation;
//   BP  dx[m, lb bL + i] = sum_g sum_j g[m, rb bR + j] w[rb, f, i, j],
//                          (rb, f) = (out_idx, out_slot)[lb, g];
//   UP  dw[rb, f, i, j] = sum_m x[m, blk[rb, f] bL + i] g[m, rb bR + j],
//       db[rb bR + j] = sum_m g[m, rb bR + j] (f32).
//
// What bounds them on the card: at the paper's batch (256 rows) launch
// latency (the Table I junction moves about 1 MB, 0.3 us at 3.35 TB/s);
// at full-set rows (8000) f32 operations (CIFAR's 4000 -> 500 junction,
// 6.4 GFLOP, 95 us at 67 TFLOP/s) or bytes in bf16.
//
// What the design does about it (simple first, speed later):
// * FF and BP are one kernel, a gather of input blocks against the slab of
//   each output block (BP reads the slab transposed through strides). A
//   CTA owns 32 rows by a run of whole output blocks, about 64 columns
//   (64 / bR blocks of bR <= 64; a 64-column chunk of a wider block), so a
//   1- or 2-column block does not idle a warp. Each output block sums its
//   slots' input blocks one after another, K = fan-in x block elements, in
//   a fixed order; a stage takes bk of them (several slots at once when the
//   blocks are narrow, so TIMIT's 40 slots of 2 run in 20 stages, not 40),
//   staged in shared memory as f32 through a per-stage table of input
//   columns and slab offsets, the loads issued 8 at a time before they are
//   stored. Each thread owns one column and 8 rows and reads 4 inputs at
//   once (one 16-byte shared load) for 4 slab values kept in registers.
//   No split, no atomics: each output is one thread's ordered sum.
// * UP: a CTA owns one right block's columns (at most 64) by a group of its
//   fan-in slots (at most 256 outputs), and loops over every row of M in
//   stages; where it has fewer than 256 outputs the threads split the rows
//   by phase and add the phases' sums in order through shared memory. The
//   loads go 8 at a time, as in FF. db is a sequential f32 column sum by
//   the slot group's first CTA.
#include "csd_spmm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;                            // output columns per CTA
constexpr int kRows = 32;                            // rows per CTA (FF, BP)
constexpr int kRowGroups = kThreads / kCols;         // 4
constexpr int kRowsPerThread = kRows / kRowGroups;   // 8
constexpr int kBatch = 8;  // global loads a thread keeps in flight
// the per-stage tables of FF/BP: input column and slab offset of each of
// the at most 256 (block, k) pairs of a stage
constexpr int kTables = 2 * 4 * kThreads;

// (row, col) of the flat index tid + kThreads u of a row-major array of
// `cols` columns, stepped u by u without a division
struct Walk {
  int row, col, drow, dcol, cols;
  __device__ Walk(int t, int n) : row(t / n), col(t % n),
                                  drow(kThreads / n), dcol(kThreads % n),
                                  cols(n) {}
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// ---------------------------------------------------------------------------
// FF and BP: the gather kernel
// ---------------------------------------------------------------------------

// A CTA's share of n_ob output blocks of width ow, each summing K = n_slots
// iw input elements (its slots' input blocks one after another): nb whole
// blocks (ow <= 64) or one 64-column chunk of a block (ow > 64, `chunks`
// per block); bk of the K elements per stage, a multiple of 4 with nb bk
// <= 256, so that narrow blocks take several slots a stage.
struct GatherGeo {
  int nb;
  int chunks;
  int bk;
  int tiles_x;
};

__host__ __device__ inline GatherGeo gather_geo(int n_ob, int ow, int k) {
  GatherGeo g;
  if (ow <= kCols) {
    g.nb = kCols / ow;
    g.chunks = 1;
    g.tiles_x = (n_ob + g.nb - 1) / g.nb;
  } else {
    g.nb = 1;
    g.chunks = (ow + kCols - 1) / kCols;
    g.tiles_x = n_ob * g.chunks;
  }
  const int quads = (k + 3) / 4;
  int cap = kCols / g.nb;
  if (cap > 16) cap = 16;
  if (cap < 1) cap = 1;
  g.bk = 4 * (quads < cap ? quads : cap);
  return g;
}

// floats of one staged input block: kRows rows of bk, 4 more so that
// consecutive blocks start 16 bytes apart in the shared-memory banks
__host__ __device__ inline int x_stride(int bk) { return kRows * bk + 4; }

inline size_t gather_smem(const GatherGeo& g) {
  return kTables + 4 * (static_cast<size_t>(g.nb) * x_stride(g.bk) +
                        static_cast<size_t>(g.bk) * kCols);
}

plan::Dims gather_dims(int E, int M, int n_ob, int k, int ow) {
  const GatherGeo g = gather_geo(n_ob, ow, k);
  return {dim3(g.tiles_x, (M + kRows - 1) / kRows, E), kThreads,
          gather_smem(g)};
}

// out[e, m, ob ow + j] = act(sum_s sum_k in[e, m, src(ob, s) iw + k]
//                            W(ob, s)[k, j] + bias[e, ob ow + j]).
// FF (DX false): src = idx[ob, s], slab ob n_slots + s, W[k, j] at
// k ow + j. BP (DX true): src = idx[ob, s] (out_idx), slab src d_in_b +
// slot[ob, s] (out_slot), W[k, j] = w[.., j, k] at j iw + k.
template <typename T, bool DX>
__global__ void __launch_bounds__(kThreads)
    csd_spmm_small_gather_kernel(const T* __restrict__ in,
                                 const T* __restrict__ w,
                                 const int* __restrict__ idx,
                                 const int* __restrict__ slot,
                                 const T* __restrict__ bias,
                                 T* __restrict__ out, T* __restrict__ zout,
                                 int M, int in_cols, int out_cols, int n_ob,
                                 int n_slots, int iw, int ow, int d_in_b,
                                 int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_xoff = reinterpret_cast<int*>(smem);  // input column, or -1
  int* s_woff = s_xoff + kThreads;             // slab offset of row k
  float* xs = reinterpret_cast<float*>(smem + kTables);
  const int K = n_slots * iw;
  const GatherGeo geo = gather_geo(n_ob, ow, K);
  const int nb = geo.nb, bk = geo.bk, xst = x_stride(bk);
  float* ws = xs + nb * xst;

  const bool narrow = ow <= kCols;
  const int ob0 = narrow ? blockIdx.x * nb : blockIdx.x / geo.chunks;
  const int j0 = narrow ? 0 : (blockIdx.x % geo.chunks) * kCols;
  const int nb_here = narrow ? min(nb, n_ob - ob0) : 1;
  const int n_valid = narrow ? nb_here * ow : min(kCols, ow - j0);
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const T* in_e = in + static_cast<size_t>(e) * M * in_cols;
  const T* w_e = w + static_cast<size_t>(e) * n_ob * n_slots * iw * ow;
  const int slab_size = iw * ow;
  const int wsk = DX ? 1 : ow;   // stride of k in a slab
  const int wsj = DX ? iw : 1;   // stride of j in a slab

  const int tid = threadIdx.x;
  const int c = tid % kCols;
  const int rg = tid / kCols;
  const int b = narrow ? min(c / ow, nb - 1) : 0;  // past n_valid: unused
  // the slab values this thread stages: column wc of the tile (of block
  // wb, column wj within it), rows wk0 + 4 u of the stage
  const int wc = tid % kCols, wk0 = tid / kCols;
  const bool w_col = wc < n_valid;
  const int wb = narrow ? min(wc / ow, nb - 1) : 0;
  const int wj_off = (narrow ? wc % ow : j0 + wc) * wsj;
  const int x_lines = nb * kRows;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    // the stage's tables: (block bb, element kl) = k0 + kl of block bb
    if (tid < nb * bk) {
      const int bb = tid / bk, k = k0 + tid % bk;
      int xo = -1, wo = 0;
      if (bb < nb_here && k < K) {
        const int ob = ob0 + bb, s = k / iw, kk = k % iw;
        const int src = idx[ob * n_slots + s];
        xo = src * iw + kk;
        wo = (DX ? src * d_in_b + slot[ob * n_slots + s] : ob * n_slots + s)
                 * slab_size + kk * wsk;
      }
      s_xoff[tid] = xo;
      s_woff[tid] = wo;
    }
    __syncthreads();
    // x: nb blocks x 32 rows x bk, kBatch loads in flight, then stored
    Walk wl(tid, bk), ws_(tid, bk);
    for (int q0 = 0; q0 < x_lines * bk; q0 += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int bb = wl.row / kRows, r = wl.row % kRows;
        const int xo = wl.row < x_lines ? s_xoff[bb * bk + wl.col] : -1;
        v[u] = xo >= 0 && r < rows
                   ? csd::to_f32(in_e[static_cast<size_t>(m0 + r) * in_cols +
                                      xo])
                   : 0.f;
        wl.next();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (ws_.row < x_lines)
          xs[(ws_.row / kRows) * xst + (ws_.row % kRows) * bk + ws_.col] =
              v[u];
        ws_.next();
      }
    }
    // w: bk rows x 64 columns, thread (wk0 + 4 u, wc)
    for (int k1 = wk0; k1 < bk; k1 += 4 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int kl = k1 + 4 * u;
        const bool ok = w_col && kl < bk && s_xoff[wb * bk + kl] >= 0;
        v[u] = ok ? csd::to_f32(w_e[static_cast<size_t>(
                        s_woff[wb * bk + kl] + wj_off)])
                  : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k1 + 4 * u < bk) ws[(k1 + 4 * u) * kCols + wc] = v[u];
    }
    __syncthreads();
    const float* xb = xs + b * xst + rg * kRowsPerThread * bk;
    for (int k = 0; k < bk; k += 4) {
      const float w0 = ws[k * kCols + c], w1 = ws[(k + 1) * kCols + c];
      const float w2 = ws[(k + 2) * kCols + c], w3 = ws[(k + 3) * kCols + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(xb + i * bk + k);
        acc[i] = fmaf(xv.x, w0, acc[i]);
        acc[i] = fmaf(xv.y, w1, acc[i]);
        acc[i] = fmaf(xv.z, w2, acc[i]);
        acc[i] = fmaf(xv.w, w3, acc[i]);
      }
    }
    __syncthreads();
  }
  if (c >= n_valid) return;
  const int col = ob0 * ow + j0 + c;
  const float bv =
      bias != nullptr ? csd::to_f32(bias[static_cast<size_t>(e) * out_cols +
                                         col])
                      : 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg * kRowsPerThread + i;
    if (r >= rows) break;
    const size_t o =
        (static_cast<size_t>(e) * M + m0 + r) * out_cols + col;
    const float z = acc[i] + bv;
    if (zout != nullptr) csd::store(z, zout + o);
    csd::store(csd::activate(z, act), out + o);
  }
}

// ---------------------------------------------------------------------------
// UP: dw and db
// ---------------------------------------------------------------------------

// A CTA's share of dw: columns [q0, q0 + qw) of right block rb (n_qc chunks
// of qw = min(bR, 64)), and either nf whole slots (bL <= 256 / qw) or one
// slot's rows [i0, i0 + blc) (n_ic chunks); at most 256 outputs = P x qw,
// P = nf blc. rp row phases when there are fewer outputs than threads;
// mc rows of M per stage.
struct DwGeo {
  int qw, n_qc, nf, blc, n_ic, p_tiles, outs, rp, mc;
};

__host__ __device__ inline DwGeo dw_geo(int d_in_b, int bl, int br) {
  DwGeo g;
  g.qw = br < kCols ? br : kCols;
  g.n_qc = (br + g.qw - 1) / g.qw;
  const int pmax = kThreads / g.qw;
  if (bl <= pmax) {
    g.nf = pmax / bl < d_in_b ? pmax / bl : d_in_b;
    g.blc = bl;
    g.n_ic = 1;
    g.p_tiles = (d_in_b + g.nf - 1) / g.nf;
  } else {
    g.nf = 1;
    g.blc = pmax;
    g.n_ic = (bl + pmax - 1) / pmax;
    g.p_tiles = d_in_b * g.n_ic;
  }
  const int p = g.nf * g.blc;
  g.outs = p * g.qw;
  g.rp = kThreads / g.outs;
  g.mc = 64;
  while (g.mc > 8 && g.mc * p > 4096) g.mc /= 2;
  return g;
}

// bytes of the x column table: one int for each of the at most 256 staged
// x columns
constexpr int kDwTable = 4 * kThreads;

inline size_t dw_smem(const DwGeo& g) {
  const size_t p = static_cast<size_t>(g.nf) * g.blc;
  return kDwTable +
         4 * (g.mc * p + static_cast<size_t>(g.mc) * g.qw +
              (g.rp > 1 ? static_cast<size_t>(g.rp) * g.outs : 0));
}

plan::Dims dw_dims(int E, int n_rb, int d_in_b, int bl, int br) {
  const DwGeo g = dw_geo(d_in_b, bl, br);
  return {dim3(g.n_qc, g.p_tiles, E * n_rb), kThreads, dw_smem(g)};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    csd_spmm_small_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             const int* __restrict__ block_idx,
                             T* __restrict__ dw, float* __restrict__ db,
                             int M, int n_in, int n_rb, int d_in_b, int bl,
                             int br) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DwGeo geo = dw_geo(d_in_b, bl, br);
  const int p_len = geo.nf * geo.blc;
  int* s_col = reinterpret_cast<int*>(smem);  // x column, or -1: no block
  float* xs = reinterpret_cast<float*>(smem + kDwTable);
  float* gs = xs + geo.mc * p_len;
  float* red = gs + geo.mc * geo.qw;

  const int e = blockIdx.z / n_rb, rb = blockIdx.z % n_rb;
  const int q0 = blockIdx.x * geo.qw;
  const int qn = min(geo.qw, br - q0);
  const int f0 = geo.n_ic == 1 ? blockIdx.y * geo.nf : blockIdx.y / geo.n_ic;
  const int i0 = geo.n_ic == 1 ? 0 : (blockIdx.y % geo.n_ic) * geo.blc;
  const int n_out = n_rb * br;
  const T* x_e = x + static_cast<size_t>(e) * M * n_in;
  const T* g_e = g + static_cast<size_t>(e) * M * n_out;
  const int tid = threadIdx.x;
  if (tid < p_len) {
    const int f = f0 + tid / geo.blc, i = i0 + tid % geo.blc;
    s_col[tid] = f < d_in_b && i < bl ? block_idx[rb * d_in_b + f] * bl + i
                                      : -1;
  }

  const int o = tid % geo.outs;
  const int ph = tid / geo.outs;  // < rp for the threads that compute
  const int p = o / geo.qw, q = o % geo.qw;
  const bool want_db = db != nullptr && blockIdx.y == 0;
  float acc = 0.f, dbacc = 0.f;
  __syncthreads();
  for (int m0 = 0; m0 < M; m0 += geo.mc) {
    const int rows = min(geo.mc, M - m0);
    // x and g: at most 4096 elements each, kBatch loads in flight
    Walk wx(tid, p_len), sx(tid, p_len), wg(tid, geo.qw), sg(tid, geo.qw);
    for (int u0 = 0; u0 < 4096 / kThreads; u0 += kBatch) {
      float xv[kBatch], gv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int col = wx.row < rows ? s_col[wx.col] : -1;
        xv[u] = col >= 0 ? csd::to_f32(x_e[static_cast<size_t>(m0 + wx.row) *
                                               n_in + col])
                         : 0.f;
        gv[u] = wg.row < rows && wg.col < qn
                    ? csd::to_f32(g_e[static_cast<size_t>(m0 + wg.row) *
                                          n_out +
                                      static_cast<size_t>(rb) * br + q0 +
                                      wg.col])
                    : 0.f;
        wx.next();
        wg.next();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (sx.row < geo.mc) xs[sx.row * p_len + sx.col] = xv[u];
        if (sg.row < geo.mc) gs[sg.row * geo.qw + sg.col] = gv[u];
        sx.next();
        sg.next();
      }
    }
    __syncthreads();
    if (ph < geo.rp)
      for (int r = ph; r < rows; r += geo.rp)
        acc = fmaf(xs[r * p_len + p], gs[r * geo.qw + q], acc);
    if (want_db && tid < qn)
      for (int r = 0; r < rows; ++r) dbacc += gs[r * geo.qw + tid];
    __syncthreads();
  }
  if (geo.rp > 1) {
    if (ph < geo.rp) red[ph * geo.outs + o] = acc;
    __syncthreads();
    if (tid >= geo.outs) return;
    acc = 0.f;
    for (int r = 0; r < geo.rp; ++r) acc += red[r * geo.outs + o];
  }
  if (want_db && tid < qn)
    db[static_cast<size_t>(e) * n_out + static_cast<size_t>(rb) * br + q0 +
       tid] = dbacc;
  if (ph != 0) return;
  const int f = f0 + p / geo.blc, i = i0 + p % geo.blc, j = q0 + q;
  if (f >= d_in_b || i >= bl || j >= br) return;
  csd::store(acc, dw + ((((static_cast<size_t>(e) * n_rb + rb) * d_in_b + f) *
                             bl + i) * br + j));
}

template <typename T>
int launch_gather(bool dx, const void* in, const void* w, const int* idx,
                  const int* slot, const void* bias, void* out, void* zout,
                  int E, int M, int in_cols, int out_cols, int n_ob,
                  int n_slots, int iw, int ow, int d_in_b, int act,
                  cudaStream_t s) {
  const plan::Dims d = gather_dims(E, M, n_ob, n_slots * iw, ow);
  auto k = dx ? csd_spmm_small_gather_kernel<T, true>
              : csd_spmm_small_gather_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(d.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<d.grid, d.threads, d.smem, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(w), idx, slot,
      static_cast<const T*>(bias), static_cast<T*>(out),
      static_cast<T*>(zout), M, in_cols, out_cols, n_ob, n_slots, iw, ow,
      d_in_b, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* g, const int* block_idx, void* dw,
              float* db, int E, int M, int n_in, int n_rb, int d_in_b, int bl,
              int br, cudaStream_t s) {
  const plan::Dims d = dw_dims(E, n_rb, d_in_b, bl, br);
  cudaError_t err = cudaFuncSetAttribute(
      csd_spmm_small_dw_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(d.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  csd_spmm_small_dw_kernel<T><<<d.grid, d.threads, d.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), block_idx,
      static_cast<T*>(dw), db, M, n_in, n_rb, d_in_b, bl, br);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = act(x W + b) (and z = x W + b when z is given) over E experts of M
// rows: x (E, M, n_in), w (E, n_rb, d_in_b, bL, bR), block_idx (n_rb,
// d_in_b) int32, bias (E, n_rb bR) or null, y and z (E, M, n_rb bR); dtype
// 0 float32, 1 bfloat16; act 0 none, 1 relu, 2 gelu (tanh). Preconditions
// (checked by the Python wrapper): contiguous tensors on one device, n_in a
// multiple of bL, E and ceil(M / 32) at most 65535, an expert's slab
// fewer than 2^31 elements. Returns
// cudaGetLastError() after the launch.
extern "C" int csd_spmm_small_fwd(const void* x, const void* w,
                                  const int* block_idx, const void* bias,
                                  void* y, void* z, int E, int M, int n_in,
                                  int n_rb, int d_in_b, int bl, int br,
                                  int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int n_out = n_rb * br;
  if (dtype == 0)
    return launch_gather<float>(false, x, w, block_idx, nullptr, bias, y, z,
                                E, M, n_in, n_out, n_rb, d_in_b, bl, br,
                                d_in_b, act, s);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16>(false, x, w, block_idx, nullptr,
                                        bias, y, z, E, M, n_in, n_out, n_rb,
                                        d_in_b, bl, br, d_in_b, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx = g W^T over the scatter form: g (E, M, n_rb bR) (the masked
// cotangent), w (E, n_rb, d_in_b, bL, bR), out_idx/out_slot (n_lb, d_out_b)
// int32, dx (E, M, n_lb bL). Preconditions as csd_spmm_small_fwd's.
extern "C" int csd_spmm_small_dx(const void* g, const void* w,
                                 const int* out_idx, const int* out_slot,
                                 void* dx, int E, int M, int n_rb, int d_in_b,
                                 int bl, int br, int n_lb, int d_out_b,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_in = n_lb * bl, n_out = n_rb * br;
  if (dtype == 0)
    return launch_gather<float>(true, g, w, out_idx, out_slot, nullptr, dx,
                                nullptr, E, M, n_out, n_in, n_lb, d_out_b,
                                br, bl, d_in_b, 0, s);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16>(true, g, w, out_idx, out_slot,
                                        nullptr, dx, nullptr, E, M, n_out,
                                        n_in, n_lb, d_out_b, br, bl, d_in_b,
                                        0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw = x^T g per block, summed over each expert's M rows: x (E, M, n_in), g
// (E, M, n_rb bR), block_idx (n_rb, d_in_b) int32, dw (E, n_rb, d_in_b,
// bL, bR) in the dtype of x; db (E, n_rb bR) f32 or null. Preconditions:
// as csd_spmm_small_fwd's, E n_rb at most 65535 and the slot tiles
// (dw_geo) at most 65535.
extern "C" int csd_spmm_small_dw(const void* x, const void* g,
                                 const int* block_idx, void* dw, float* db,
                                 int E, int M, int n_in, int n_rb,
                                 int d_in_b, int bl, int br, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, g, block_idx, dw, db, E, M, n_in, n_rb,
                            d_in_b, bl, br, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, g, block_idx, dw, db, E, M, n_in,
                                    n_rb, d_in_b, bl, br, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch csd_spmm_small_fwd (n_ob = n_rb, k = d_in_b bL, ow = bR) or
// csd_spmm_small_dx (n_ob = n_lb, k = d_out_b bR, ow = bL) makes, from the
// host code it launches with: six ints (plan.cuh) written to out. Returns
// 1, or -1 for an unknown dtype.
extern "C" int csd_spmm_small_gather_plan(int E, int M, int n_ob, int k,
                                          int ow, int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return -1;
  plan::put(out, 0, gather_dims(E, M, n_ob, k, ow));
  return 1;
}

// The launch csd_spmm_small_dw makes: six ints written to out. Returns 1,
// or -1 for an unknown dtype.
extern "C" int csd_spmm_small_dw_plan(int E, int n_rb, int d_in_b, int bl,
                                      int br, int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return -1;
  plan::put(out, 0, dw_dims(E, n_rb, d_in_b, bl, br));
  return 1;
}
