// csd_spmm_small — the block-sparse junction's forward and backward-data
// for blocks whose bL or bR is not a multiple of 64, on Hopper's CUDA
// cores (sm_90a), f32 accumulation; one junction (E = 1) or E expert
// junctions of one shared pattern. The backward-weights of these blocks is
// csd_spmm_small_dw.cu.
//
// Replaces, for these block shapes, the TPU kernels of
// repro/kernels/csd_spmm.py: csd_spmm_fwd (#1) and _csd_spmm_fwd_batched
// (#3), and csd_spmm_dx (#6). The paper's own MLP runs blocks of 16 x 4,
// 4 x 4, 1 x 2 and 2 x 1 (shrink_to_divisor of a 16 cap at widths 800,
// 100, 390, 39), and the LM smoke configurations 16 x 16: below the 64-wide
// tiles of every wgmma/TMA body (csd_spmm_fwd.cu, _dx.cu), with rows of 39,
// 100 or 390 elements whose byte strides are not all multiples of 16.
// Plain versions: kernels/csd_spmm.py csd_spmm_{fwd,dx}(_batched)_plain.
//
// The same kernel is the int8 forward at these blocks (the slab type WT
// int8_t), in place of csd_spmm.py's _csd_spmm_fwd_quant (#4) and
// _csd_spmm_fwd_quant_batched (#5): q (E, n_rb, d_in_b, bL, bR) int8 with
// one f32 scale s[e, rb, f] per block,
//
//   y[e, m, rb bR + j] = act(sum_f (sum_k x[e, m, blk(f) bL + k] q[k, j])
//                            s[e, rb, f] + bias[e, rb bR + j]).
//
// A thread's CW columns lie in one output block, so a slot's scale is one
// scalar: each slot is summed in f32 into its own register tile, which is
// multiplied by the slot's scale (one rounding) and then added (another),
// as the plain version does; the scale is never folded into the weights
// (csd_spmm_fwd_quant.cu keeps the same convention). int8 rows of a 16 x 4,
// 1 x 2 or 2 x 1 block are 4, 2 or 1 bytes: they are loaded CW bytes at a
// time through the read-only path (no wider alignment assumed) and widened
// exactly. The int8 slab is a quarter of the f32 one's bytes; x, y and
// the arithmetic are the f32 form's, so the bounds below hold for it too.
// Its two-CTA 4 x 4 form (128 registers: an accumulator and a slot tile of
// 8 x 4 each) spills a few words; forms that do not (the slot summed half
// the rows at a time, or one x row a step over a packed slab) measured
// slower at every phase-3d shape (PERF.md, section 6).
//
// FF and BP are one gather kernel, csd_spmm_small_gather_kernel:
//
//   out[e, m, ob ow + j] = act(sum_s sum_k in[e, m, src(ob, s) iw + k]
//                              W(ob, s)[k, j] + bias[e, ob ow + j])
//
// FF: in = x, ob a right block (ow = bR), src = block_idx[ob, s], iw = bL,
// W(ob, s) = w[ob, s] (bL x bR, k-major). BP: in = the masked cotangent g,
// ob a left block (ow = bL), src = out_idx[ob, s] (a right block, iw = bR),
// W(ob, s)[k, j] = w[src, out_slot[ob, s], j, k]: the slab read transposed.
//
// What bounds it on the card (f32, the paper MLP's junctions):
// * 8000 rows (the full training set): operations and L2 traffic. CIFAR's
//   4000 -> 500 junction is 6.4 GFLOP (95 us at 67 TFLOP/s); its x is 128
//   MB, its slab 1.6 MB. Table I's 800 -> 100 is 256 MFLOP over 29 MB of
//   x and y (8.6 us at 3.35 TB/s): bytes.
// * 256 rows (the batch): latency. Table I moves 1 MB (0.3 us); a launch
//   and one round trip to device memory cost several us, so what counts is
//   how few dependent steps a CTA takes and how many SMs share the work.
//
// What the design does about it:
// * Staged rows avoid bank conflicts: rows are 16 bytes past a multiple of
//   128 apart (a warp's rows of one column fall in distinct bank groups),
//   and in 8-row tiles, where every lane of a warp reads the same row,
//   input blocks whose bytes are an even number of 16-byte bank groups
//   (bL 16 f32: 64 bytes) get 16 bytes of padding, so the blocks the lanes
//   gather spread over all 8 groups instead of 2 (4-way conflicts on every
//   x read; CIFAR's forward at 8000 rows 852 -> 697 us, PERF.md).
// * Input rows are staged once per CTA. A CTA owns a tile of R rows (8,
//   16, 32 or 64) and a range of output columns up to the whole output
//   width; the tile's whole input rows go into shared memory once, and
//   every output block of the range gathers its slots' input blocks from
//   there. So x is read from L2 once per output range, not once per output
//   block: at CIFAR's 8000 rows x costs 128 MB (whole-width ranges, one
//   read; gathered per output block it is read fan-out = 25 times, 3.3
//   GB), the slab 1.6 MB per 8-row tile (1.6 GB of L2 reads: R is 8
//   because one CIFAR row is 16 KB, 20 padded, and two tiles do not fit),
//   y 16 MB. Table I at 8000 rows: x 25.6 MB once (32-row tiles, the
//   whole output width 100), the slab 64 KB per tile (16 MB), y 3.2 MB.
// * Copies overlap arithmetic. A CTA walks its row tiles (y, y + gridDim.y,
//   ...) through a ring of up to 3 stages filled with cp.async (16-byte
//   copies where a row's byte width allows, else 8 or 4; plain loads for
//   bf16 rows of odd width), one commit group per tile, the next tiles in
//   flight while the current one is consumed.
// * The product is register-tiled: a thread owns 8 rows (strided R / 8
//   apart) by CW = 4 (2, 1) columns of one output block, and steps the
//   fan-in KQ = 4 (2, 1) input elements at a time. Per 4 input elements it
//   reads 8 x vectors from shared memory and 4 slab vectors (through L1;
//   the threads of one column group are one warp's neighbours and share
//   them) for 128 FMAs: 12 loads per 128 FMAs, 3 per 32 (a thread of one
//   column and 8 rows issues 12 shared loads per 32). A slot's pattern
//   entries are read one slot ahead, so its slab loads wait for one round
//   trip to L2, not two; where shared memory holds one CTA an SM (CIFAR's
//   forward), the 4 x 4 form is built for one CTA and loads the next
//   slot's slab while it sums this one.
// * The card fills at small M. Fewer rows a tile, output ranges split
//   over CTAs, and the fan-in (whole slots) split over ks ranks of the
//   CTA's 256 threads: the ranks leave f32 partial sums in the consumed
//   stage and the CTA adds them in rank order. launch.small_gather_split
//   picks R, the range, ks and the stages (a rule read off
//   tools/time_small.py --splits). A split of the fan-in over a
//   thread-block cluster, the ranks' sums added through distributed shared
//   memory, was built and swept at every phase-3d shape (clusters of 2-8):
//   it lost to the split inside the CTA everywhere, 1.2-10x (PERF.md,
//   section 6), and went.
// * No atomics: each output is one thread's ordered sum (slots in order,
//   input elements in order), or the ranks' sums added in fixed order, so
//   two runs are bit-equal.
#include "csd_spmm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 8;           // rows a thread
constexpr int kMaxStages = 3;
constexpr int kSmemOptin = 232448;
constexpr int kSmemPerSm = 233472;   // an H100 SM's shared memory
constexpr int kSmemReserved = 1024;  // the system's share of each CTA
constexpr int kRegCtas = 2;          // CTAs an SM holds by registers

// The launch geometry (the host picks R, ncg, ks and stages; the rest
// follows): a tile of R rows by ncg column groups of cw columns (rc
// columns), the fan-in split over ks ranks in the CTA (per_ks slots each);
// bs elements between staged input blocks of iw, rs between staged rows; a
// stage of `stage` bytes holds a tile's input rows, and afterwards the
// ranks' partial sums.
struct GatherGeo {
  int R, ncg, rc, ks, stages;
  int per_ks;
  int bs, rs;
  int stage;
};

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int column_group(int ow) {
  return ow % 4 == 0 ? 4 : ow % 2 == 0 ? 2 : 1;
}

// Elements between staged input blocks of iw elements: iw, and 16 bytes
// more in 8-row tiles (where a warp's lanes read one row) where the
// block's bytes are an even number of 16-byte groups.
__host__ __device__ inline int block_stride(int iw, int size, int R) {
  const int b = iw * size;
  return R == kTR && b % 16 == 0 && (b / 16) % 2 == 0 ? iw + 16 / size : iw;
}

__host__ __device__ inline GatherGeo gather_geo(int in_cols, int size,
                                                int n_slots, int iw, int ow,
                                                int R, int ncg, int ks,
                                                int stages) {
  GatherGeo g;
  g.R = R;
  g.ncg = ncg;
  g.rc = ncg * column_group(ow);
  g.ks = ks;
  g.stages = stages;
  g.per_ks = ceil_div(n_slots, ks);
  g.bs = block_stride(iw, size, R);
  // rows 16 bytes past a multiple of 128: a warp's 8 rows of one column
  // land in distinct bank groups
  g.rs = ceil_div(in_cols / iw * g.bs, 128 / size) * (128 / size) +
         16 / size;
  const long x_bytes = static_cast<long>(R) * g.rs * size;
  const long red_bytes = ks > 1 ? 4L * ks * R * g.rc : 0;
  const long b = x_bytes > red_bytes ? x_bytes : red_bytes;
  g.stage = static_cast<int>((b + 15) / 16 * 16);
  return g;
}

bool gather_ok(const GatherGeo& g, int n_slots, int ow) {
  const int nrg = g.R / kTR;
  return (g.R == 8 || g.R == 16 || g.R == 32 || g.R == 64) && g.ncg >= 1 &&
         g.ks >= 1 && g.ks <= n_slots && nrg * g.ncg * g.ks <= kThreads &&
         g.stages >= 1 && g.stages <= kMaxStages && ow >= 1 &&
         static_cast<long>(g.stages) * g.stage <= kSmemOptin;
}

plan::Dims gather_dims(const GatherGeo& g, int E, int n_cg, int Y) {
  return {dim3(ceil_div(n_cg, g.ncg), Y, E), kThreads,
          static_cast<size_t>(g.stages) * g.stage};
}

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    csd::cp_async_wait<0>();
  else if (n == 1)
    csd::cp_async_wait<1>();
  else
    csd::cp_async_wait<2>();
}

// ---------------------------------------------------------------------------
// the gather kernel
// ---------------------------------------------------------------------------

// N consecutive f32 values stored as T at p (aligned to N elements).
template <int N>
__device__ __forceinline__ void store_vec(const float (&v)[N], float* p) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

template <int N>
__device__ __forceinline__ void store_vec(const float (&v)[N],
                                          __nv_bfloat16* p) {
  if constexpr (N == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&a),
                   *reinterpret_cast<const unsigned*>(&b));
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

// A 16 x 4 slab (rows ow apart) into registers, through the read-only path.
template <typename T>
__device__ __forceinline__ void load_slab16(const T* p, int ow,
                                            float (&w)[16][4]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) csd::load_vec<true>(p + k * ow, w[k]);
}

// acc[i][j] += sum_k x[row i][k] w[k][j] over a slot's 16 staged inputs
// (rows rstr elements apart), k in order (the scale is the int8 form's).
template <typename T>
__device__ __forceinline__ void sum_slab16(float (&acc)[kTR][4],
                                           const T* xp, int rstr,
                                           const float (&w)[16][4], float) {
#pragma unroll
  for (int k0 = 0; k0 < 16; k0 += 4)
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float xv[4];
      csd::load_vec<false>(xp + i * rstr + k0, xv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(xv[kk], w[k0 + kk][j], acc[i][j]);
    }
}

// acc += part * sc, element by element, each product and sum rounded as
// the plain version rounds them (no contraction into an FMA).
template <int CW>
__device__ __forceinline__ void add_scaled(float (&acc)[kTR][CW],
                                           const float (&part)[kTR][CW],
                                           float sc) {
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j)
      acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(part[i][j], sc));
}

// A 16 x 4 int8 slab (rows ow bytes apart) into registers, packed: a row
// a word, through the read-only path.
__device__ __forceinline__ void load_slab16(const int8_t* p, int ow,
                                            unsigned (&q)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    q[k] = __ldg(reinterpret_cast<const unsigned*>(p + k * ow));
}

// The int8 form of sum_slab16: the slot's sum in its own f32 tile (each
// slab row widened once, exactly), then acc += sum * sc.
template <typename T>
__device__ __forceinline__ void sum_slab16(float (&acc)[kTR][4],
                                           const T* xp, int rstr,
                                           const unsigned (&q)[16],
                                           float sc) {
  float part[kTR][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < 16; k0 += 4) {
    float w[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[kk][j] = static_cast<float>(
            static_cast<int8_t>(q[k0 + kk] >> (8 * j)));
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float xv[4];
      csd::load_vec<false>(xp + i * rstr + k0, xv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[i][j] = fmaf(xv[kk], w[kk][j], part[i][j]);
    }
  }
  add_scaled(acc, part, sc);
}

// acc[i][j] += sum_k in[row i][k] W[k][j] over one slot: the staged input
// block at xp (rows xstr elements apart), the slab at wp (FF: W = w[ob, s],
// bL x bR row-major; BP: W = w[src, f] read transposed); KQ input elements
// a step, k in order.
template <bool DX, int CW, int KQ, int OCC, typename T, typename WT>
__device__ __forceinline__ void sum_slot(float (&acc)[kTR][CW], const T* xp,
                                         int xstr, const WT* wp, int iw,
                                         int ow, int j0) {
#pragma unroll(OCC == 1 ? 4 : 1)
  for (int k0 = 0; k0 < iw; k0 += KQ) {
    float wv[KQ][CW];
    if constexpr (DX) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        float t[KQ];
        csd::load_vec<true>(wp + (j0 + j) * iw + k0, t);
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) wv[kk][j] = t[kk];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        csd::load_vec<true>(wp + (k0 + kk) * ow + j0, wv[kk]);
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float xv[KQ];
      csd::load_vec<false>(xp + i * xstr + k0, xv);
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
        for (int j = 0; j < CW; ++j)
          acc[i][j] = fmaf(xv[kk], wv[kk][j], acc[i][j]);
    }
  }
}

// CTA (grp, y, e): column groups [grp ncg, grp ncg + ncg) of expert e, row
// tiles y, y + gridDim.y, ... Thread tid: rows rg + nrg i (i < 8) of the
// tile, column group cgl, fan-in rank kr (slots [kr per_ks, kr per_ks +
// per_ks)), tid = rg + nrg (cgl + ncg kr). WT int8_t: the int8 forward
// (FF only), with the blocks' f32 scales (E, n_ob, n_slots).
template <typename T, typename WT, bool DX, int CW, int KQ, int OCC>
__global__ void __launch_bounds__(kThreads, OCC)
    csd_spmm_small_gather_kernel(const T* __restrict__ in,
                                 const WT* __restrict__ w,
                                 const float* __restrict__ scale,
                                 const int* __restrict__ idx,
                                 const int* __restrict__ slot,
                                 const T* __restrict__ bias,
                                 T* __restrict__ out, T* __restrict__ zout,
                                 int M, int in_cols, int out_cols, int n_ob,
                                 int n_slots, int iw, int ow, int d_in_b,
                                 int act, int R, int ncg, int ks,
                                 int stages) {
  constexpr bool kQuant = std::is_same<WT, int8_t>::value;
  static_assert(!(kQuant && DX), "the int8 form has no backward");
  extern __shared__ __align__(16) unsigned char smem[];
  const GatherGeo geo = gather_geo(in_cols, sizeof(T), n_slots, iw, ow, R,
                                   ncg, ks, stages);
  const int nrg = R / kTR;
  const int cg0 = blockIdx.x * ncg;
  const int n_cg = out_cols / CW;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid % nrg;
  const int cgl = (tid / nrg) % ncg;
  const int kr = tid / (nrg * ncg);
  const int cg = cg0 + cgl;
  const bool mine = kr < ks && cg < n_cg;  // a column group to sum
  const int col = cg * CW;                 // its first output column
  const int ob = col / ow, j0 = col % ow;
  const int s_lo = kr * geo.per_ks;
  const int s_hi = mine ? min(s_lo + geo.per_ks, n_slots) : s_lo;
  const T* in_e = in + static_cast<size_t>(e) * M * in_cols;
  const WT* w_e = w + static_cast<size_t>(e) * n_ob * n_slots * iw * ow;
  // the slots' scales of this thread's output block (int8)
  const float* sc_ob =
      kQuant ? scale + (static_cast<size_t>(e) * n_ob + ob) * n_slots
             : nullptr;
  const int slab = iw * ow;
  const bool reduce = ks > 1;
  // whole rows as one segment, or block by block where blocks are padded
  const int seg = geo.bs == iw ? in_cols : iw;
  const int vbytes = csd::piece_bytes(seg * static_cast<int>(sizeof(T)));
  const int n_tiles = ceil_div(M, R);
  const int y0 = blockIdx.y, ys = gridDim.y;
  const int my_tiles = y0 < n_tiles ? (n_tiles - 1 - y0) / ys + 1 : 0;
  auto stage_ptr = [&](int u) {
    return smem + static_cast<size_t>(u % stages) * geo.stage;
  };
  const int sstride = geo.bs == iw ? in_cols : geo.bs;
  auto issue = [&](int u) {
    if (u < my_tiles) {
      const int m0 = (y0 + u * ys) * R;
      csd::copy_segments(
          vbytes, reinterpret_cast<T*>(stage_ptr(u)), geo.rs,
          in_e + static_cast<size_t>(m0) * in_cols,
          static_cast<size_t>(in_cols), min(R, M - m0), in_cols / seg, seg,
          [&](int b) { return b * seg; },
          [&](int b) { return b * sstride; });
    }
    csd::cp_async_commit();
  };

  float bv[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j)
    bv[j] = bias != nullptr && mine
                ? csd::to_f32(bias[static_cast<size_t>(e) * out_cols + col +
                                   j])
                : 0.f;

  for (int u = 0; u < stages - 1; ++u) issue(u);
  for (int u = 0; u < my_tiles; ++u) {
    issue(u + stages - 1);
    cp_async_wait_n(stages - 1);
    __syncthreads();
    const int m0 = (y0 + u * ys) * R;
    const T* xs = reinterpret_cast<const T*>(stage_ptr(u));
    float acc[kTR][CW];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

    // the slot's pattern entries are loaded one slot ahead, so a slot's
    // slab loads wait for one round trip, not two
    const int* idx_ob = idx + ob * n_slots;
    const int* slot_ob = DX ? slot + ob * n_slots : nullptr;
    int src_n = s_lo < s_hi ? __ldg(idx_ob + s_lo) : 0;
    int f_n = DX && s_lo < s_hi ? __ldg(slot_ob + s_lo) : 0;
    bool summed = false;
    if constexpr (OCC == 1 && !DX && CW == 4 && KQ == 4) {
      // FF at 16-element input blocks where one CTA holds the SM (CIFAR's
      // 16 x 4): a slot's whole slab in registers, the next slot's loaded
      // while this one is summed (two register sets in turn; int8: the
      // slab packed a row a word, each slot's sum scaled)
      if (iw == 16 && s_lo < s_hi) {
        const WT* w_ob = w_e + static_cast<size_t>(ob) * n_slots * slab + j0;
        const T* x_rg = xs + rg * geo.rs;
        const int rstr = nrg * geo.rs;
        using Slab = std::conditional_t<kQuant, unsigned[16], float[16][4]>;
        Slab wa, wb;
        float sa = 1.f, sb = 1.f;  // the slots' scales (int8)
        load_slab16(w_ob + static_cast<size_t>(s_lo) * slab, ow, wa);
        if constexpr (kQuant) sa = __ldg(sc_ob + s_lo);
        int src_a = src_n, src_b = 0;
        for (int s = s_lo; s < s_hi; s += 2) {
          if (s + 1 < s_hi) {
            load_slab16(w_ob + static_cast<size_t>(s + 1) * slab, ow, wb);
            src_b = __ldg(idx_ob + s + 1);
            if constexpr (kQuant) sb = __ldg(sc_ob + s + 1);
          }
          sum_slab16(acc, x_rg + src_a * geo.bs, rstr, wa, sa);
          if (s + 1 >= s_hi) break;
          if (s + 2 < s_hi) {
            load_slab16(w_ob + static_cast<size_t>(s + 2) * slab, ow, wa);
            src_a = __ldg(idx_ob + s + 2);
            if constexpr (kQuant) sa = __ldg(sc_ob + s + 2);
          }
          sum_slab16(acc, x_rg + src_b * geo.bs, rstr, wb, sb);
        }
        summed = true;
      }
    }
    for (int s = s_lo; s < (summed ? s_lo : s_hi); ++s) {
      const int src = src_n, f = f_n;
      if (s + 1 < s_hi) {
        src_n = __ldg(idx_ob + s + 1);
        if (DX) f_n = __ldg(slot_ob + s + 1);
      }
      const size_t wb =
          DX ? (static_cast<size_t>(src) * d_in_b + f) * slab
             : (static_cast<size_t>(ob) * n_slots + s) * slab;
      const WT* wp = w_e + wb;
      const T* xp = xs + rg * geo.rs + src * geo.bs;
      if constexpr (kQuant) {
        // the slot's sum in its own tile, then scaled and added
        const float sc = __ldg(sc_ob + s);
        float part[kTR][CW] = {};
        sum_slot<DX, CW, KQ, OCC>(part, xp, nrg * geo.rs, wp, iw, ow, j0);
        add_scaled(acc, part, sc);
      } else {
        sum_slot<DX, CW, KQ, OCC>(acc, xp, nrg * geo.rs, wp, iw, ow, j0);
      }
    }

    if (!reduce) {
      if (mine) {
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const int m = m0 + rg + nrg * i;
          if (m >= M) break;
          const size_t o =
              (static_cast<size_t>(e) * M + m) * out_cols + col;
          float z[CW], y[CW];
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            z[j] = acc[i][j] + bv[j];
            y[j] = csd::activate(z[j], act);
          }
          if (zout != nullptr) store_vec(z, zout + o);
          store_vec(y, out + o);
        }
      }
    } else {
      // the ranks' partial sums: red[(kr R + r) rc + c], in this stage
      __syncthreads();  // every thread has read the staged rows
      float* red = reinterpret_cast<float*>(stage_ptr(u));
      if (mine) {
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < CW; ++j)
            red[(kr * R + rg + nrg * i) * geo.rc + cgl * CW + j] = acc[i][j];
      }
      __syncthreads();
      // the tile's outputs, the ranks' sums added in rank order
      const int c_n = min(geo.rc, out_cols - cg0 * CW);
      for (int q = tid; q < R * c_n; q += kThreads) {
        const int r = q / c_n, c = q % c_n;
        const int m = m0 + r;
        if (m >= M) continue;
        float z = 0.f;
        for (int k2 = 0; k2 < ks; ++k2) z += red[(k2 * R + r) * geo.rc + c];
        const int oc = cg0 * CW + c;
        if (bias != nullptr)
          z += csd::to_f32(bias[static_cast<size_t>(e) * out_cols + oc]);
        const size_t o = (static_cast<size_t>(e) * M + m) * out_cols + oc;
        if (zout != nullptr) csd::store(z, zout + o);
        csd::store(csd::activate(z, act), out + o);
      }
    }
    __syncthreads();  // the stage is free for the tile u + stages
  }
  csd::cp_async_wait<0>();
}

template <typename T, typename WT, bool DX>
using GatherFn = void (*)(const T*, const WT*, const float*, const int*,
                          const int*, const T*, T*, T*, int, int, int, int,
                          int, int, int, int, int, int, int, int, int);

template <typename T, typename WT, bool DX, int CW>
GatherFn<T, WT, DX> pick_kq(int kq) {
  return kq == 4 ? csd_spmm_small_gather_kernel<T, WT, DX, CW, 4, kRegCtas>
         : kq == 2
             ? csd_spmm_small_gather_kernel<T, WT, DX, CW, 2, kRegCtas>
             : csd_spmm_small_gather_kernel<T, WT, DX, CW, 1, kRegCtas>;
}

// The kernel for CW x KQ. Where shared memory holds one CTA an SM, the 4 x
// 4 product (the paper MLP's 16 x 4 and 4 x 4 blocks) is built for one CTA:
// it keeps the registers two would share, unrolls the fan-in 4 steps deep
// and, at 16-element input blocks, holds a slot's slab in registers while
// the next slot's loads (CIFAR's forward at 8000 rows, the fan-in whole:
// 643 us against 861 with the two-CTA form, PERF.md).
template <typename T, typename WT, bool DX>
GatherFn<T, WT, DX> pick(int cw, int kq, bool one_cta) {
  if (one_cta && cw == 4 && kq == 4)
    return csd_spmm_small_gather_kernel<T, WT, DX, 4, 4, 1>;
  return cw == 4   ? pick_kq<T, WT, DX, 4>(kq)
         : cw == 2 ? pick_kq<T, WT, DX, 2>(kq)
                   : pick_kq<T, WT, DX, 1>(kq);
}

// The launch's geometry and dims for x of `size` bytes an element, or
// false for a geometry the kernel does not take: what the launcher and the
// plan exports share.
bool gather_launch_dims(int E, int n_ob, int ow, int iw, int in_cols,
                        int n_slots, int size, int R, int ncg, int ks,
                        int stages, int Y, plan::Dims* d) {
  const GatherGeo g = gather_geo(in_cols, size, n_slots, iw, ow, R, ncg, ks,
                                 stages);
  if (!gather_ok(g, n_slots, ow) || Y < 1 || Y > 65535 || E > 65535)
    return false;
  *d = gather_dims(g, E, n_ob * ow / column_group(ow), Y);
  return true;
}

template <typename T, typename WT, bool DX>
int launch_gather(const void* in, const void* w, const float* scale,
                  const int* idx, const int* slot, const void* bias,
                  void* out, void* zout, int E, int M, int in_cols,
                  int out_cols, int n_ob, int n_slots, int iw, int ow,
                  int d_in_b, int act, int R, int ncg, int ks, int stages,
                  int Y, cudaStream_t s) {
  plan::Dims d;
  if (!gather_launch_dims(E, n_ob, ow, iw, in_cols, n_slots, sizeof(T), R,
                          ncg, ks, stages, Y, &d))
    return static_cast<int>(cudaErrorInvalidValue);
  const GatherFn<T, WT, DX> k = pick<T, WT, DX>(
      column_group(ow), column_group(iw),
      kSmemPerSm / (static_cast<int>(d.smem) + kSmemReserved) < 2);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(d.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<d.grid, d.threads, d.smem, s>>>(
      static_cast<const T*>(in), static_cast<const WT*>(w), scale, idx, slot,
      static_cast<const T*>(bias), static_cast<T*>(out),
      static_cast<T*>(zout), M, in_cols, out_cols, n_ob, n_slots, iw, ow,
      d_in_b, act, R, ncg, ks, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = act(x W + b) (and z = x W + b when z is given) over E experts of M
// rows: x (E, M, n_in), w (E, n_rb, d_in_b, bL, bR), block_idx (n_rb,
// d_in_b) int32, bias (E, n_rb bR) or null, y and z (E, M, n_rb bR); dtype
// 0 float32, 1 bfloat16; act 0 none, 1 relu, 2 gelu (tanh). The geometry
// (launch.small_gather_split): R rows a tile, ncg column groups a CTA, ks
// fan-in ranks in a CTA, stages, Y CTAs along the row tiles.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, n_in a multiple of bL, an expert's slab fewer than 2^31
// elements. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a geometry the kernel does not take).
extern "C" int csd_spmm_small_fwd(const void* x, const void* w,
                                  const int* block_idx, const void* bias,
                                  void* y, void* z, int E, int M, int n_in,
                                  int n_rb, int d_in_b, int bl, int br,
                                  int dtype, int act, int R, int ncg, int ks,
                                  int stages, int Y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int n_out = n_rb * br;
  if (dtype == 0)
    return launch_gather<float, float, false>(
        x, w, nullptr, block_idx, nullptr, bias, y, z, E, M, n_in, n_out,
        n_rb, d_in_b, bl, br, d_in_b, act, R, ncg, ks, stages, Y, s);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16, __nv_bfloat16, false>(
        x, w, nullptr, block_idx, nullptr, bias, y, z, E, M, n_in, n_out,
        n_rb, d_in_b, bl, br, d_in_b, act, R, ncg, ks, stages, Y, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 forward: y = act(sum_f (x block of block_idx[rb, f]) q[rb, f]
// scale[rb, f] + b) over E experts of M rows: x (E, M, n_in) f32/bf16, q
// (E, n_rb, d_in_b, bL, bR) int8, scale (E, n_rb, d_in_b) f32, bias (E,
// n_rb bR) like x or null, y (E, M, n_rb bR) like x. Geometry and
// preconditions as csd_spmm_small_fwd's (the geometry is x's, the same
// rule's).
extern "C" int csd_spmm_small_fwd_quant(const void* x, const void* q,
                                        const float* scale,
                                        const int* block_idx,
                                        const void* bias, void* y, int E,
                                        int M, int n_in, int n_rb,
                                        int d_in_b, int bl, int br, int dtype,
                                        int act, int R, int ncg, int ks,
                                        int stages, int Y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 2 || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_out = n_rb * br;
  if (dtype == 0)
    return launch_gather<float, int8_t, false>(
        x, q, scale, block_idx, nullptr, bias, y, nullptr, E, M, n_in, n_out,
        n_rb, d_in_b, bl, br, d_in_b, act, R, ncg, ks, stages, Y, s);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16, int8_t, false>(
        x, q, scale, block_idx, nullptr, bias, y, nullptr, E, M, n_in, n_out,
        n_rb, d_in_b, bl, br, d_in_b, act, R, ncg, ks, stages, Y, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx = g W^T over the scatter form: g (E, M, n_rb bR) (the masked
// cotangent), w (E, n_rb, d_in_b, bL, bR), out_idx/out_slot (n_lb, d_out_b)
// int32, dx (E, M, n_lb bL). Geometry and preconditions as
// csd_spmm_small_fwd's.
extern "C" int csd_spmm_small_dx(const void* g, const void* w,
                                 const int* out_idx, const int* out_slot,
                                 void* dx, int E, int M, int n_rb, int d_in_b,
                                 int bl, int br, int n_lb, int d_out_b,
                                 int dtype, int R, int ncg, int ks,
                                 int stages, int Y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_in = n_lb * bl, n_out = n_rb * br;
  if (dtype == 0)
    return launch_gather<float, float, true>(
        g, w, nullptr, out_idx, out_slot, nullptr, dx, nullptr, E, M, n_out,
        n_in, n_lb, d_out_b, br, bl, d_in_b, 0, R, ncg, ks, stages, Y, s);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16, __nv_bfloat16, true>(
        g, w, nullptr, out_idx, out_slot, nullptr, dx, nullptr, E, M, n_out,
        n_in, n_lb, d_out_b, br, bl, d_in_b, 0, R, ncg, ks, stages, Y, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch csd_spmm_small_fwd or csd_spmm_small_fwd_quant (n_ob = n_rb,
// ow = bR, iw = bL, in_cols = n_in, n_slots = d_in_b; dtype that of x) or
// csd_spmm_small_dx (n_ob = n_lb, ow = bL, iw = bR, in_cols = n_out,
// n_slots = d_out_b) makes with the given geometry,
// from the host code it launches with: six ints (plan.cuh) written to out.
// Returns 1, or -1 for an unknown dtype or a geometry the kernel does not
// take.
extern "C" int csd_spmm_small_gather_plan(int E, int n_ob, int ow, int iw,
                                          int in_cols, int n_slots,
                                          int dtype, int R, int ncg, int ks,
                                          int stages, int Y, int* out) {
  plan::Dims d;
  if ((dtype != 0 && dtype != 1) ||
      !gather_launch_dims(E, n_ob, ow, iw, in_cols, n_slots,
                          dtype == 0 ? 4 : 2, R, ncg, ks, stages, Y, &d))
    return -1;
  plan::put(out, 0, d);
  return 1;
}
