// csd_spmm_small_dw — the block-sparse junction's backward-weights (and
// the bias gradient) for blocks whose bL or bR is not a multiple of 64, on
// Hopper's CUDA cores (sm_90a), f32 accumulation; one junction (E = 1) or
// E expert junctions of one shared pattern.
//
// Replaces, for these block shapes, the TPU kernel csd_spmm_dw (#7) of
// repro/kernels/csd_spmm.py: the paper MLP's 16 x 4, 4 x 4, 1 x 2 and 2 x 1
// blocks and the LM smoke configurations' 16 x 16. Plain versions:
// kernels/csd_spmm.py csd_spmm_dw(_batched)_plain.
//
//   dw[e, rb, f, i, j] = sum_m x[e, m, block_idx[rb, f] bL + i]
//                              g[e, m, rb bR + j],
//   db[e, rb bR + j] = sum_m g[e, m, rb bR + j] (f32).
//
// What bounds it on the card (f32): at 8000 rows operations and L2
// traffic (CIFAR_MLP's 4000 -> 500 junction: 6.4 GFLOP, 95 us at 67
// TFLOP/s; x 128 MB, g 16 MB), at 256 rows latency (Table I moves 1 MB).
//
// What the design does about it:
// * Outputs are grouped by left block. CTA (rank, lb, e) owns every slab
//   (rb, f) whose input block is lb: it finds them itself, scanning
//   block_idx in flat order (a ballot and a prefix over the warps), so the
//   order is fixed. Its x is one bL-wide column strip, read once; g is
//   gathered as the strips of the strip's consumers, fan-out x bR wide.
//   Grouped by right block instead, x is read fan-out times:
//   3.2 GB at CIFAR's 8000 rows; grouped by left block x costs 128 MB and
//   the gathered g 800 MB (bL = 16 > bR = 4), Table I 25.6 + 32 MB.
// * M is split over the CTAs of a thread-block cluster (up to 8, along x):
//   rank c sums rows [c ceil(M / C), ...) into f32 partials, and after a
//   cluster barrier each rank adds every rank's partials, in rank order,
//   for its share of the outputs through distributed shared memory. Table
//   I at 8000 rows runs 50 left blocks x C CTAs, each over 8000 / C rows.
//   launch.small_dw_cluster picks C (a rule read off tools/time_small.py
//   --splits).
// * The product is register-tiled: a thread owns a TI x TJ tile of one slab
//   (16 x 4 = 64 outputs at the paper's blocks; at 16 x 16 four threads
//   share a slab) and a phase of the rows; per row it reads TI x values (4
//   float4, the same for every slab of the strip: a broadcast) and TJ g
//   values (one float4) for TI TJ FMAs: 5 shared loads per 64 FMAs (one
//   output a thread: two per FMA). The phases' sums are added in phase
//   order.
// * Copies are pipelined: a ring of 3 stages of 32 KB filled with cp.async
//   (16-byte pieces where a strip's bytes allow, else 8 or 4; plain loads
//   for bf16 strips of odd width), the next stages in flight while the
//   current one is consumed. g is staged once per row chunk for all the
//   slabs of the strip.
// * db rides along: the tiles of slot 0 (each right block has one) add
//   their g values as they go, and are reduced with dw.
// * No atomics: every output is summed in a fixed order (rows of a phase,
//   phases, ranks), so two runs are bit-equal.
#include "csd_spmm_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kStages = 3;
constexpr int kStageBytes = 32768;
// before the ring: the batch's slabs (kThreads ints), the warps' counts and
// a resume position
constexpr int kHeader = 4 * (kThreads + 16);
constexpr int kSmem = kHeader + kStages * kStageBytes;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// the thread tile: TI rows of a slab (bL) by TJ columns (bR)
__host__ __device__ inline int tile_rows(int bl) {
  return bl % 16 == 0 ? 16 : bl % 4 == 0 ? 4 : bl % 2 == 0 ? 2 : 1;
}
__host__ __device__ inline int tile_cols(int br) {
  return br % 4 == 0 ? 4 : br % 2 == 0 ? 2 : 1;
}

plan::Dims dw_dims(int E, int n_lb, int cluster) {
  plan::Dims d{dim3(cluster, n_lb, E), kThreads, static_cast<size_t>(kSmem)};
  d.cluster = cluster;
  return d;
}

// N consecutive staged elements as f32, 4 at a time where N allows.
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      float t[4];
      csd::load_vec<false>(p + u, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[u + i] = t[i];
    }
  } else {
    csd::load_vec<false>(p, v);
  }
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// CTA (rank, lb, e) of a (cluster, n_lb, E) grid, clusters along x: the
// slabs whose input block is lb, over rows [rank mpr, rank mpr + mpr) of
// expert e, in batches of at most qg slabs (tp tiles each, at most 256
// tiles a batch unless one slab has more: then groups of 256 of its tiles).
// Thread tid of a group of ni tiles: tile tid % ni, row phase tid / ni
// (P = 256 / ni phases, fewer where the rank's rows are few).
template <typename T, int TI, int TJ>
__global__ void __launch_bounds__(kThreads, 2)
    csd_spmm_small_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             const int* __restrict__ block_idx,
                             T* __restrict__ dw, float* __restrict__ db,
                             int M, int n_in, int n_rb, int d_in_b, int bl,
                             int br, int cluster) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_list = reinterpret_cast<int*>(smem);  // flat rb d_in_b + f
  int* s_warp = s_list + kThreads;
  int* s_resume = s_warp + kThreads / 32;
  unsigned char* ring = smem + kHeader;
  constexpr int kVals = TI * TJ + TJ;  // a tile's dw and db sums

  const int rank = blockIdx.x, lb = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_out = n_rb * br;
  const int N = n_rb * d_in_b;
  const int ntj = br / TJ;
  const int tp = (bl / TI) * ntj;
  const int qg = max(1, kThreads / tp);
  const int mpr = ceil_div(M, cluster);
  const int r_begin = min(M, rank * mpr);
  const int r_end = min(M, r_begin + mpr);
  const T* x_e = x + static_cast<size_t>(e) * M * n_in +
                 static_cast<size_t>(r_begin) * n_in + lb * bl;
  const T* g_e = g + static_cast<size_t>(e) * M * n_out +
                 static_cast<size_t>(r_begin) * n_out;
  constexpr int kSize = sizeof(T);
  const int xw = ceil_div(bl, 16 / kSize) * (16 / kSize);
  // pieces that tile a strip and the rows (the lowest set bit bounds both)
  const int vx = csd::piece_bytes((bl * kSize) | (n_in * kSize));
  const int vg = csd::piece_bytes((br * kSize) | (n_out * kSize));

  int pos = 0;
  // the scan reads block_idx one round ahead of the round it ranks: a
  // round's loads are in flight during the previous round's barriers
  int ahead = tid < N ? __ldg(block_idx + tid) : -1;
  while (pos < N) {
    // -- the next batch: at most qg slabs of lb, in flat order ------------
    int nq = 0;
    while (nq < qg && pos < N) {
      const int i = pos + tid;
      const bool hit = i < N && ahead == lb;
      const int nxt = i + kThreads < N ? __ldg(block_idx + i + kThreads) : -1;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w2 = 0; w2 < kThreads / 32; ++w2) {
        const int c = s_warp[w2];
        before += w2 < warp ? c : 0;
        total += c;
      }
      const int rk = before + __popc(bal & ((1u << lane) - 1u));
      const int room = qg - nq;
      if (hit && rk < room) s_list[nq + rk] = i;
      if (hit && rk == room) *s_resume = i;
      __syncthreads();
      if (total > room) {
        pos = *s_resume;
        nq = qg;
        ahead = pos + tid < N ? __ldg(block_idx + pos + tid) : -1;
      } else {
        pos += kThreads;
        nq += total;
        ahead = nxt;
      }
      __syncthreads();  // s_warp and s_resume are read
    }
    if (nq == 0) break;

    // -- each group of at most 256 tiles of the batch ---------------------
    const int items = nq * tp;
    for (int it0 = 0; it0 < items; it0 += kThreads) {
      const int ni = min(kThreads, items - it0);
      // row phases: as many as the threads give, at least 4 rows each (a
      // phase more costs a load in every output's ordered phase sum)
      const int P = min(kThreads / ni, max(1, ceil_div(r_end - r_begin, 4)));
      const int q_lo = it0 / tp, q_hi = (it0 + ni - 1) / tp + 1;
      const int ng = q_hi - q_lo;
      const int gw = ceil_div(ng * br, 16 / kSize) * (16 / kSize);
      const int rows_fit = kStageBytes / ((xw + gw) * kSize);
      const int mc = rows_fit >= P ? P * (rows_fit / P) : rows_fit;
      const int nst = ceil_div(r_end - r_begin, mc);
      const int itl = tid % ni, ph = tid / ni;
      const bool work = ph < P;
      const int it = it0 + itl;
      const int q = it / tp, t2 = it % tp;
      const int ti = t2 / ntj, tj = t2 % ntj;
      const int flat = s_list[q];
      const bool want_db = db != nullptr && work && flat % d_in_b == 0 &&
                           ti == 0;
      auto stage = [&](int u) {
        return reinterpret_cast<T*>(ring + (u % kStages) * kStageBytes);
      };
      auto issue = [&](int u) {
        if (u < nst) {
          const int m0 = u * mc;
          const int nr = min(mc, r_end - r_begin - m0);
          T* xs = stage(u);
          T* gs = xs + mc * xw;
          csd::copy_segments(vx, xs, xw,
                             x_e + static_cast<size_t>(m0) * n_in,
                             static_cast<size_t>(n_in), nr, 1, bl,
                             [](int) { return 0; }, [](int) { return 0; });
          csd::copy_segments(
              vg, gs, gw, g_e + static_cast<size_t>(m0) * n_out,
              static_cast<size_t>(n_out), nr, ng, br,
              [&](int k) { return (s_list[q_lo + k] / d_in_b) * br; },
              [&](int k) { return k * br; });
        }
        csd::cp_async_commit();
      };

      float acc[TI][TJ], dba[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) dba[j] = 0.f;

      for (int u = 0; u < kStages - 1; ++u) issue(u);
      for (int u = 0; u < nst; ++u) {
        issue(u + kStages - 1);
        csd::cp_async_wait<kStages - 1>();
        __syncthreads();
        if (work) {
          const int nr = min(mc, r_end - r_begin - u * mc);
          const T* xs = stage(u);
          const T* xr = xs + ti * TI;
          const T* gr = xs + mc * xw + (q - q_lo) * br + tj * TJ;
          for (int r = ph; r < nr; r += P) {
            float xv[TI], gv[TJ];
            load_row(xr + r * xw, xv);
            load_row(gr + r * gw, gv);
#pragma unroll
            for (int i = 0; i < TI; ++i)
#pragma unroll
              for (int j = 0; j < TJ; ++j)
                acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
            if (want_db) {
#pragma unroll
              for (int j = 0; j < TJ; ++j) dba[j] += gv[j];
            }
          }
        }
        __syncthreads();  // the stage is free for u + kStages
      }
      csd::cp_async_wait<0>();

      // -- the phases' sums in phase order, then the ranks' -------------
      float* red = reinterpret_cast<float*>(ring);
      if (work) {
        float* o = red + (ph * ni + itl) * kVals;
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < TJ; ++j) o[i * TJ + j] = acc[i][j];
#pragma unroll
        for (int j = 0; j < TJ; ++j) o[TI * TJ + j] = dba[j];
      }
      __syncthreads();
      for (int v = tid; v < ni * kVals; v += kThreads) {
        float z = red[v];
        for (int p2 = 1; p2 < P; ++p2) z += red[p2 * ni * kVals + v];
        red[v] = z;
      }
      if (cluster > 1)
        hopper::cluster_sync();
      else
        __syncthreads();
      const int ipr = ceil_div(ni, cluster);
      const int i_lo = min(ni, rank * ipr), i_hi = min(ni, i_lo + ipr);
      const uint32_t red_a = hopper::smem_addr(red);
      for (int v = tid; v < (i_hi - i_lo) * kVals; v += kThreads) {
        const int il = i_lo + v / kVals, k = v % kVals;
        const int off = il * kVals + k;
        float z = 0.f;
        if (cluster > 1) {
          for (int c2 = 0; c2 < cluster; ++c2)
            z += ld_cluster_f32(hopper::map_to_rank(red_a, c2) + 4u * off);
        } else {
          z = red[off];
        }
        const int it2 = it0 + il;
        const int q2 = it2 / tp, u2 = it2 % tp;
        const int ti2 = u2 / ntj, tj2 = u2 % ntj;
        const int fl2 = s_list[q2];
        if (k < TI * TJ) {
          const int i = ti2 * TI + k / TJ, j = tj2 * TJ + k % TJ;
          csd::store(z, dw + ((static_cast<size_t>(e) * N + fl2) * bl + i) *
                                 br + j);
        } else if (db != nullptr && fl2 % d_in_b == 0 && ti2 == 0) {
          db[static_cast<size_t>(e) * n_out + (fl2 / d_in_b) * br +
             tj2 * TJ + k - TI * TJ] = z;
        }
      }
      if (cluster > 1) hopper::cluster_sync();  // the peers have read
      __syncthreads();  // red and s_list are free
    }
  }
}

template <typename T>
using DwFn = void (*)(const T*, const T*, const int*, T*, float*, int, int,
                      int, int, int, int, int);

template <typename T, int TI>
DwFn<T> pick_tj(int tj) {
  return tj == 4   ? csd_spmm_small_dw_kernel<T, TI, 4>
         : tj == 2 ? csd_spmm_small_dw_kernel<T, TI, 2>
                   : csd_spmm_small_dw_kernel<T, TI, 1>;
}

template <typename T>
DwFn<T> pick(int ti, int tj) {
  return ti == 16  ? pick_tj<T, 16>(tj)
         : ti == 4 ? pick_tj<T, 4>(tj)
         : ti == 2 ? pick_tj<T, 2>(tj)
                   : pick_tj<T, 1>(tj);
}

bool dw_ok(int E, int n_lb, int cluster) {
  return cluster >= 1 && cluster <= kMaxCluster && n_lb >= 1 &&
         n_lb <= 65535 && E >= 1 && E <= 65535;
}

template <typename T>
int launch_dw(const void* x, const void* g, const int* block_idx, void* dw,
              float* db, int E, int M, int n_in, int n_rb, int d_in_b, int bl,
              int br, int cluster, cudaStream_t s) {
  const int n_lb = n_in / bl;
  if (!dw_ok(E, n_lb, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const plan::Dims d = dw_dims(E, n_lb, cluster);
  const DwFn<T> k = pick<T>(tile_rows(bl), tile_cols(br));
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(d.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = d.grid;
  cfg.blockDim = dim3(d.threads);
  cfg.dynamicSmemBytes = d.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k, static_cast<const T*>(x),
                           static_cast<const T*>(g), block_idx,
                           static_cast<T*>(dw), db, M, n_in, n_rb, d_in_b,
                           bl, br, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dw = x^T g per block, summed over each expert's M rows: x (E, M, n_in), g
// (E, M, n_rb bR), block_idx (n_rb, d_in_b) int32, dw (E, n_rb, d_in_b,
// bL, bR) in the dtype of x; db (E, n_rb bR) f32 or null; M split over a
// cluster of `cluster` CTAs (launch.small_dw_cluster). Preconditions
// (checked by the Python wrapper): contiguous tensors on one device, n_in a
// multiple of bL, M > 0. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a grid the kernel does not take).
extern "C" int csd_spmm_small_dw(const void* x, const void* g,
                                 const int* block_idx, void* dw, float* db,
                                 int E, int M, int n_in, int n_rb,
                                 int d_in_b, int bl, int br, int dtype,
                                 int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, g, block_idx, dw, db, E, M, n_in, n_rb,
                            d_in_b, bl, br, cluster, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, g, block_idx, dw, db, E, M, n_in,
                                    n_rb, d_in_b, bl, br, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch csd_spmm_small_dw makes: six ints written to out. Returns 1,
// or -1 for an unknown dtype or a grid the kernel does not take.
extern "C" int csd_spmm_small_dw_plan(int E, int n_lb, int cluster,
                                      int dtype, int* out) {
  if ((dtype != 0 && dtype != 1) || !dw_ok(E, n_lb, cluster)) return -1;
  plan::put(out, 0, dw_dims(E, n_lb, cluster));
  return 1;
}
