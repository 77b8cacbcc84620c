// Forward wavefront sweep of the pair-HMM / partition-function models.
//
// Replaces the Pallas TPU kernel `sweep` (mlprobs_tpu/ops/pallas/
// wavefront_kernel.py, `sweep` / `_sweep_jit` / `_sweep_kernel_body`).
// Same contract as the plain PyTorch version (ops/wavefront.py,
// `wavefront_forward`): for each requested model, the (D, B, W) plane of
// the M (or Zm) state -- or with emit_pre the pre-emission accumulator --
// the (D, B) log2 scale of every diagonal and the (B,) log2 total.
// D = 2*Lp + 1 rows, W = Lp + 1 lanes; row d, lane j is grid cell
// (d - j, j).
//
// What bounds it on the H100.  Writing the planes is the card's bound
// (~0.5 ms at Lp = 512, B = 256, three models).  But each diagonal
// depends on the one before through the rescale's row max, so a (pair,
// model) is a chain of 2Lp+1 steps, and the latency of one step, a few
// hundred dependent instructions of one warp, sets the time: about 1 us
// a diagonal on an H100, whatever the model or the lanes per thread.
// The design keeps that chain short and every state on chip.
//
// Layout.  One block per (pair, model) -- or, past 1,024 lanes, a
// cluster of up to 8 blocks that split the lanes and meet in distributed
// shared memory.  Each thread owns LPT = 4 contiguous lanes; thread 0 of
// the first block also owns lane 0 (at Lp = 512: 4 warps, 3 blocks an
// SM).  The loop over diagonals runs inside the block (the TPU's
// sequential grid axis).  The (., j-1) dependency sits in the thread's
// own registers, crosses threads by one shuffle, and crosses warps (and
// blocks) through one shared slot per warp edge.  Shared memory holds
// pm, pins, and the x row laid out so that lane j of diagonal d reads
// x_{d-j} at one address with no bounds test (each lane's x class then
// moves one lane right per diagonal, in registers); no global memory is
// read inside the loop.
//
// Past 8,192 lanes (sequences of more than 8,192 residues) the same code
// runs with LPT = 32, up to 65,536 lanes in 8 blocks: a thread then holds
// more states than registers, and the spilled ones live in local memory
// (the L1 and L2 caches).  The blocks' maxima meet in the cluster as
// before, so the scales stay exact.  The x row in shared memory bounds
// that instance at Lp of about 43,000.
//
// The critical path of one diagonal: the cells of the thread's lanes
// (independent, so they run back to back); one warp max (a single integer
// redux: the values are non-negative, so their bit patterns order as the
// floats do); one store of it; the one barrier; a vector load of the
// per-warp maxima; the power of two built from the exponent field; then
// the scaling and the neighbour sums, a few dozen operations a lane.  The
// plane row goes out through the warp's staging row, so each warp store
// covers 32 consecutive floats.
// The local model's row sums travel one diagonal late, and one warp folds
// them into the log2 total every 32 diagonals, off that path.
//
// The scales.  Each diagonal is rescaled by the power of two of its own
// row max, exactly as the plain version does, so the scales are the plain
// version's bit for bit and nothing downstream moves.  A lane's states are
// scaled, and the sums its right neighbour reads are formed from the
// scaled states in the plain version's order, as there; a lane's left
// neighbour hands over its unscaled states (a shuffle, or one shared slot
// across a warp or block edge) and they are scaled on arrival.  So the
// arithmetic is the plain version's op for op, subnormal values included:
// on a long pair a region of the diagonal that sat far below the row max
// can grow to set it later, and a sum formed before the scaling would
// round such values differently.  Built with --fmad=false, so every
// product and sum rounds as the plain version's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int PAD = 20;
constexpr float TINY = 1e-38f;

// per-model table layout, in floats (mirrors ops/kernels/wavefront_kernel.py)
constexpr int TAB_PM = 0;      // pm[21][21]
constexpr int TAB_PINS = 448;  // pins[21][2]
constexpr int TAB_T = 496;     // T[5][5], row = from-state
constexpr int TAB_INIT = 528;  // init[5]
constexpr int TAB_C1 = 536;
constexpr int TAB_C2 = 537;
constexpr int TAB_GO = 538;
constexpr int TAB_GE = 539;
constexpr int TAB_SIZE = 544;

constexpr int HMM5 = 0, LOCAL = 1, PARTITION = 2;

// contiguous lanes per thread: LPT_SHORT up to 8,192 lanes, else LPT_LONG
constexpr int LPT_SHORT = 4, LPT_LONG = 32;
constexpr int MAX_THREADS = 256;  // per block: 1,024 lanes at LPT_SHORT
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CLUSTER = 8;    // blocks per (pair, model), portable
constexpr int RING = 64;          // local model: diagonals of row sums kept
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can have

__device__ __forceinline__ float exp2i(float e) {
  // exact 2**e for integer-valued e, built from the exponent field: what
  // ldexpf(1, e) gives (and the plain version's exp2), subnormal below
  // 2**-126, 0 below 2**-149, inf above 2**127
  const int n = (int)fminf(fmaxf(e, -1000.f), 1000.f);
  if (n >= -126) return n > 127 ? INFINITY : __int_as_float((n + 127) << 23);
  return n >= -149 ? __int_as_float(1 << (n + 149)) : 0.f;
}

__device__ __forceinline__ float floor_log2(float mx) {
  // exact floor(log2(mx)) from the exponent field; 0 where mx <= 0
  if (!(mx > 0.f)) return 0.f;
  return (float)(((__float_as_int(mx) >> 23) & 0xFF) - 127);
}

__device__ __forceinline__ float logaddexp2f(float a, float b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  float m = fmaxf(a, b);
  return m + log1pf(exp2f(-fabsf(a - b))) * 1.4426950408889634f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Launch shape for W lanes: lanes 1..W-1 split over `cl` blocks of `nt`
// threads, LPT contiguous lanes each (`span` lanes a block); lane 0 rides
// in thread 0 of block 0.
struct Plan {
  int cl, nt, span;
};

template <int LPT>
__host__ __device__ inline Plan make_plan(int W) {
  const int lanes = W - 1;
  int cl = (lanes + MAX_THREADS * LPT - 1) / (MAX_THREADS * LPT);
  if (cl < 1) cl = 1;
  const int per = (lanes + cl - 1) / cl;
  int nt = ((per + LPT - 1) / LPT + 31) / 32 * 32;
  if (nt < 32) nt = 32;
  return {cl, nt, nt * LPT};
}

// shared-memory layout, in floats; the x row (bytes) comes last
struct Smem {
  int pm, pins, red, edge, ring_rs, ring_fs, stage, xs, total_bytes;
};

template <int LPT>
__host__ __device__ inline Smem smem_layout(int Lp, Plan p) {
  const int nw = p.nt / 32, R = p.cl * nw;
  Smem s;
  s.pm = 0;                              // 441 (+pad)
  s.pins = 448;                          // 42 (+pad), read as float2
  s.red = 496;                           // [2][64] per-warp maxima
  s.edge = s.red + 128;                  // [2][MAX_WARPS][8] edge states
  s.ring_rs = s.edge + 2 * MAX_WARPS * 8;  // [RING][R] warp row sums
  s.ring_fs = s.ring_rs + RING * R;      // [RING][2] (f, s) per diagonal
  s.stage = (s.ring_fs + 2 * RING + 3) / 4 * 4;  // [nw][32*LPT], 16 B
  s.xs = s.stage + nw * 32 * LPT;
  s.total_bytes = s.xs * 4 + 3 * Lp + 2 + p.cl * p.span + 16;
  return s;
}

// Per-model constants of one (pair, model), in registers.
template <int KIND>
struct Model {
  float T[KIND == HMM5 ? 25 : 9];
  float init[5];
  float c1, c2, go, ge;
  int ox, oy, lx, ly;
};

// One cell (d - j, j): the new unscaled states nv and the pre-emission
// accumulator am, from the cell's own d-1 states st, the neighbour sums
// a (from d-2, already on the d-1 scale times rc), b1 and b2 (from d-1),
// in the plain version's order.  ix and iy are hmm5's insert emissions of
// x_i and y_j; for the local model iy0 is c1 on a valid lane and 0 on a
// padding lane.  [lo, hi] are the lanes of diagonal d
// inside the grid (local, partition).  FULL = false is the form of an
// ordinary lane: no hmm5 injection, none of partition's first or last
// row or column.  It gives the same bits there as FULL = true, the
// plain version's form, which the caller runs on the few other lanes.
template <int KIND, bool FULL>
__device__ __forceinline__ void cell(const Model<KIND>& M, int d, int j,
                                     int lo, int hi, float em, float ix0,
                                     float ix1, float iy0, float iy1,
                                     const float* st, float a, float rc,
                                     float b1, float b2, float e2s1,
                                     float* nv, float& amv) {
  const int i = d - j;
  if constexpr (KIND == HMM5 && !FULL) {
    const float* T = M.T;
    const float m1 = st[0], x11 = st[1], x21 = st[3];
    const float am = a * rc;
    nv[0] = em * am;
    nv[1] = ix0 * (m1 * T[0 * 5 + 1] + x11 * T[1 * 5 + 1]);
    nv[2] = iy0 * b1;
    nv[3] = ix1 * (m1 * T[0 * 5 + 3] + x21 * T[3 * 5 + 3]);
    nv[4] = iy1 * b2;
    amv = am;
  } else if constexpr (KIND == PARTITION && !FULL) {
    const bool inb = j >= lo && j <= hi;
    const float am = a * rc;
    const float zm = em * am;
    const float zf = st[0] * M.go + st[2] * M.ge;
    const float ze = b1 * M.go + b2 * M.ge;
    nv[0] = inb ? zm : 0.f;
    nv[1] = inb ? ze : 0.f;
    nv[2] = inb ? zf : 0.f;
    amv = inb ? am : 0.f;
  } else if constexpr (KIND == HMM5) {
    const float* T = M.T;
    const float m1 = st[0], x11 = st[1], x21 = st[3];
    const int dinj = M.ox + M.oy + 1;
    const float inj_m =
        (d == dinj + 1 && j == M.oy + 1) ? M.init[0] * e2s1 : 0.f;
    const float am = a * rc + inj_m;
    const bool injx = d == dinj && j == M.oy;
    const bool injy = d == dinj && j == M.oy + 1;
    nv[0] = em * am;
    nv[1] = ix0 * ((m1 * T[0 * 5 + 1] + x11 * T[1 * 5 + 1]) +
                   (injx ? M.init[1] * e2s1 : 0.f));
    nv[2] = iy0 * (b1 + (injy ? M.init[2] * e2s1 : 0.f));
    nv[3] = ix1 * ((m1 * T[0 * 5 + 3] + x21 * T[3 * 5 + 3]) +
                   (injx ? M.init[3] * e2s1 : 0.f));
    nv[4] = iy1 * (b2 + (injy ? M.init[4] * e2s1 : 0.f));
    amv = am;
  } else if constexpr (KIND == LOCAL) {
    const float* T = M.T;
    const float m1 = st[0], x1 = st[1];
    const bool inb = j >= lo && j <= hi;
    const float am = a * rc + (inb ? e2s1 : 0.f);
    nv[0] = em * M.c2 * am;
    nv[1] = M.c1 * (m1 * T[0 * 3 + 1] + x1 * T[1 * 3 + 1]);
    nv[2] = iy0 * b1;
    amv = am;
  } else {
    const float zm1 = st[0], zf1 = st[2];
    const int ox = M.ox, oy = M.oy;
    const bool row0 = i == ox, col0 = j == oy, x_done = i == ox + M.lx;
    const bool lane_end = j == oy + M.ly;
    const bool inb =
        i >= ox && i <= ox + M.lx && j >= oy && j <= oy + M.ly;
    float am = a * rc;
    float zm = em * am;
    if (row0 && col0 && inb) zm = e2s1;
    const float gof = (col0 || lane_end) ? 1.f : M.go;
    const float gef = (col0 || lane_end) ? 1.f : M.ge;
    float zf = zm1 * gof + zf1 * gef;
    if (col0 && i > ox) zf = e2s1;
    const float goe = x_done ? 1.f : M.go;
    const float gee = x_done ? 1.f : M.ge;
    float ze = b1 * goe + b2 * gee;
    if (row0 && j > oy) ze = e2s1;
    if (!inb) zm = zf = ze = am = 0.f;
    nv[0] = zm;
    nv[1] = ze;
    nv[2] = zf;
    amv = am;
  }
}

// The sums a right neighbour reads from a cell's scaled states st: A (for
// M two diagonals later), B1, B2 (for the Y states, or Ze, on the next).
template <int KIND>
__device__ __forceinline__ void sums(const Model<KIND>& M, const float* st,
                                     float& A, float& B1, float& B2) {
  if constexpr (KIND == HMM5) {
    const float* T = M.T;
    const float m = st[0], x1 = st[1], y1 = st[2], x2 = st[3], y2 = st[4];
    A = m * T[0 * 5 + 0] + x1 * T[1 * 5 + 0] + y1 * T[2 * 5 + 0] +
        x2 * T[3 * 5 + 0] + y2 * T[4 * 5 + 0];
    B1 = m * T[0 * 5 + 2] + y1 * T[2 * 5 + 2];
    B2 = m * T[0 * 5 + 4] + y2 * T[4 * 5 + 4];
  } else if constexpr (KIND == LOCAL) {
    const float* T = M.T;
    const float m = st[0], x = st[1], y = st[2];
    A = m * T[0 * 3 + 0] + x * T[1 * 3 + 0] + y * T[2 * 3 + 0];
    B1 = m * T[0 * 3 + 2] + y * T[2 * 3 + 2];
    B2 = 0.f;
  } else {
    A = (st[0] + st[1]) + st[2];
    B1 = st[0];
    B2 = st[1];
  }
}

// The local model's log2 total over diagonals [lo, hi), hi - lo <= 32:
// one warp, lane l takes diagonal lo + l; the row sums of its warps times
// its power of two, then the terms into acc one diagonal at a time, in
// order, as the plain version adds them (a log-sum-exp of the 32 terms at
// once rounds otherwise, and over 16,000 diagonals the two totals drift
// apart by more than 1e-6 of |l2t|).
__device__ float fold_rows(float acc, int lo, int hi, const float* ring_rs,
                           const float* ring_fs, int R) {
  const int q = lo + (threadIdx.x & 31);
  float t = -INFINITY;
  if (q < hi) {
    const float* r = ring_rs + (q & (RING - 1)) * R;
    float rs = 0.f;
    for (int w = 0; w < R; ++w) rs += r[w];
    const float rowsum = rs * ring_fs[(q & (RING - 1)) * 2];
    if (rowsum > 0.f)
      t = log2f(fmaxf(rowsum, TINY)) - ring_fs[(q & (RING - 1)) * 2 + 1];
  }
  for (int k = 0; k < hi - lo; ++k)
    acc = logaddexp2f(acc, __shfl_sync(0xffffffffu, t, k));
  return acc;
}

template <bool CLUSTER>
__device__ __forceinline__ void block_sync() {
  if constexpr (CLUSTER)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// a float in block `rank` of the cluster (this block without clusters)
template <bool CLUSTER>
__device__ __forceinline__ float* at_rank(float* p, int rank) {
  if constexpr (CLUSTER)
    return cg::this_cluster().map_shared_rank(p, rank);
  else
    return p;
}

template <int KIND, bool EMIT, bool CLUSTER, int LPT>
__device__ void sweep_one(const int8_t* __restrict__ X,
                          const int8_t* __restrict__ Y, int ox, int oy,
                          int lx, int ly, const float* __restrict__ tab,
                          int B, int Lp, int b, int mi, int rank, Plan P,
                          float* __restrict__ planes,
                          float* __restrict__ scales,
                          float* __restrict__ l2t, float* smem) {
  constexpr int NS = KIND == HMM5 ? 5 : 3;
  static_assert(LPT % 4 == 0, "the plane staging stores float4s");
  const int W = Lp + 1;
  const int D = 2 * Lp + 1;
  const int nt = P.nt, tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const int nw = nt >> 5, R = P.cl * nw;
  const Smem L = smem_layout<LPT>(Lp, P);
  float* pm = smem + L.pm;
  const float2* pins2 = reinterpret_cast<const float2*>(smem + L.pins);
  float* red = smem + L.red;
  float* edge = smem + L.edge;
  float* ring_rs = smem + L.ring_rs;
  float* ring_fs = smem + L.ring_fs;
  float* stage = smem + L.stage + warp * 32 * LPT;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + L.xs);
  // thread 0 of block 0 owns lane 0, writes the scales and the local total
  const bool lead = rank == 0 && tid == 0;

  for (int k = tid; k < 441; k += nt) pm[k] = tab[TAB_PM + k];
  for (int k = tid; k < 42; k += nt) smem[L.pins + k] = tab[TAB_PINS + k];
  for (int k = tid; k < 128; k += nt) red[k] = 0.f;
  // xs[2Lp+1-d+j] = x_{d-j} (1-based), PAD outside the sequence
  const int8_t* xrow = X + (size_t)b * Lp;
  for (int k = tid; k < 3 * Lp + 2 + P.cl * P.span; k += nt) {
    const int i = 2 * Lp + 1 - k;
    xs[k] = (i >= 1 && i <= Lp) ? xrow[i - 1] : (int8_t)PAD;
  }

  Model<KIND> M;
#pragma unroll
  for (int k = 0; k < (KIND == HMM5 ? 25 : 9); ++k) M.T[k] = tab[TAB_T + k];
#pragma unroll
  for (int k = 0; k < 5; ++k) M.init[k] = tab[TAB_INIT + k];
  M.c1 = tab[TAB_C1];
  M.c2 = tab[TAB_C2];
  M.go = tab[TAB_GO];
  M.ge = tab[TAB_GE];
  M.ox = ox;
  M.oy = oy;
  M.lx = lx;
  M.ly = ly;

  // this thread's lanes j0 .. j0+LPT-1; lanes >= W are padding (y = PAD),
  // held at zero by the zero emissions of PAD (and the local model's c1
  // taken as 0 there)
  const int j0 = 1 + rank * P.span + tid * LPT;
  float st[LPT][NS], a_cur[LPT], a_next[LPT], b1s[LPT], b2s[LPT];
  float c1y[LPT];
  int yo[LPT], xc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int j = j0 + k;
    const bool valid = j < W;
#pragma unroll
    for (int s = 0; s < NS; ++s) st[k][s] = 0.f;
    a_cur[k] = a_next[k] = b1s[k] = b2s[k] = 0.f;
    const int y = valid ? Y[(size_t)b * Lp + j - 1] : PAD;
    yo[k] = y;
    c1y[k] = valid ? M.c1 : 0.f;
  }
  block_sync<CLUSTER>();
  // the x classes of "diagonal -1"; each diagonal moves them a lane right
#pragma unroll
  for (int k = 0; k < LPT; ++k) xc[k] = xs[2 * Lp + 2 + j0 + k];

  const int dterm = ox + lx + oy + ly, jt = oy + ly;
  const int dinj = ox + oy + 1;  // hmm5's injection diagonals: dinj, dinj+1
  float rc = 1.f, s1 = 0.f, acc = -INFINITY, rs_prev = 0.f;
  // lane 0 (y = PAD), in the lead thread
  float st0[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) st0[s] = 0.f;
  const float2 pad_ins = pins2[PAD];
  const float l0_iy0 = KIND == LOCAL ? M.c1 : pad_ins.x;

  for (int d = 0; d < D; ++d) {
    const int par = d & 1;
    const float e2s1 = exp2i(s1);
    const int8_t* xd = xs + (2 * Lp + 1 - d);
#pragma unroll
    for (int k = LPT - 1; k > 0; --k) xc[k] = xc[k - 1];
    xc[0] = xd[j0];

    // the lanes of diagonal d inside the grid
    const int lo = KIND == LOCAL ? max(oy + 1, d - ox - lx)
                                 : max(oy, d - ox - lx);
    const int hi = KIND == LOCAL ? min(oy + ly, d - ox - 1)
                                 : min(oy + ly, d - ox);
    // each lane's emissions: pm[x][y], and hmm5's insert emissions
    float nv[LPT][NS], amv[LPT], em[LPT];
    float2 ix[LPT], iy[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      em[k] = pm[xc[k] * 21 + yo[k]];
      ix[k] = iy[k] = make_float2(0.f, 0.f);
      if constexpr (KIND == HMM5) {
        ix[k] = pins2[xc[k]];
        iy[k] = pins2[yo[k]];
      } else if constexpr (KIND == LOCAL) {
        iy[k].x = c1y[k];
      }
      cell<KIND, false>(M, d, j0 + k, lo, hi, em[k], ix[k].x, ix[k].y,
                        iy[k].x, iy[k].y, st[k], a_cur[k], rc, b1s[k],
                        b2s[k], e2s1, nv[k], amv[k]);
    }
    // the few lanes that take the full form: hmm5's injection cells,
    // partition's first and last row and column
    bool special = false;
    if constexpr (KIND == HMM5) {
      special = (d == dinj || d == dinj + 1) &&
                (unsigned)(oy - j0 + 1) < (unsigned)(LPT + 1);
    } else if constexpr (KIND == PARTITION) {
      special = (unsigned)(oy - j0) < (unsigned)LPT ||
                (unsigned)(oy + ly - j0) < (unsigned)LPT ||
                (unsigned)(d - ox - j0) < (unsigned)LPT ||
                (unsigned)(d - ox - lx - j0) < (unsigned)LPT;
    }
    if (special) {
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = j0 + k;
        const bool full = KIND == HMM5
                              ? (j == oy || j == oy + 1)
                              : (j == oy || j == oy + ly || j == d - ox ||
                                 j == d - ox - lx);
        if (full)
          cell<KIND, true>(M, d, j, lo, hi, em[k], ix[k].x, ix[k].y,
                           iy[k].x, iy[k].y, st[k], a_cur[k], rc, b1s[k],
                           b2s[k], e2s1, nv[k], amv[k]);
      }
    }
    // the values are >= 0, so their bits order as the floats do
    unsigned mk[LPT];
    float rs = 0.f;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      mk[k] = __float_as_uint(nv[k][0]);
#pragma unroll
      for (int s = 1; s < NS; ++s) mk[k] = max(mk[k], __float_as_uint(nv[k][s]));
      if constexpr (KIND == LOCAL) rs += nv[k][0];
    }
#pragma unroll
    for (int w = 1; w < LPT; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < LPT; k += 2 * w) mk[k] = max(mk[k], mk[k + w]);
    }
    unsigned mxb = mk[0];
    float nv0[NS], am0 = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) nv0[s] = 0.f;
    if (lead) {
      const int x0 = xd[0];
      const float2 p = pins2[x0];
      const float em0 = pm[x0 * 21 + PAD];
      const bool full = KIND == HMM5        ? d == dinj && oy == 0
                        : KIND == PARTITION ? oy == 0 || d == ox ||
                                                  d == ox + lx
                                            : false;
      if (full)
        cell<KIND, true>(M, d, 0, lo, hi, em0, p.x, p.y, l0_iy0, pad_ins.y,
                         st0, 0.f, rc, 0.f, 0.f, e2s1, nv0, am0);
      else
        cell<KIND, false>(M, d, 0, lo, hi, em0, p.x, p.y, l0_iy0, pad_ins.y,
                          st0, 0.f, rc, 0.f, 0.f, e2s1, nv0, am0);
#pragma unroll
      for (int s = 0; s < NS; ++s) mxb = max(mxb, __float_as_uint(nv0[s]));
      if constexpr (KIND == LOCAL) rs += nv0[0];
      // lane 0's unscaled states, for lane 1
      float* dst = edge + par * MAX_WARPS * 8;
#pragma unroll
      for (int s = 0; s < NS; ++s) dst[s] = nv0[s];
    }
    // the warp's last lane's unscaled states, for the lane right of it
    if (wl == 31) {
      float* dst = nullptr;
      if (warp + 1 < nw)
        dst = edge + (par * MAX_WARPS + warp + 1) * 8;
      else if (CLUSTER && rank + 1 < P.cl)
        dst = at_rank<CLUSTER>(edge + par * MAX_WARPS * 8, rank + 1);
      if (dst != nullptr) {
#pragma unroll
        for (int s = 0; s < NS; ++s) dst[s] = nv[LPT - 1][s];
      }
    }
    float left[NS];  // the left neighbour's unscaled states (lanes 1..31)
#pragma unroll
    for (int s = 0; s < NS; ++s)
      left[s] = __shfl_up_sync(0xffffffffu, nv[LPT - 1][s], 1);
    mxb = __reduce_max_sync(0xffffffffu, mxb);
    if (wl == 0) {
      float* slot = red + par * 64 + rank * nw + warp;
      if constexpr (CLUSTER) {
        for (int r = 0; r < P.cl; ++r)
          *at_rank<CLUSTER>(slot, r) = __uint_as_float(mxb);
      } else {
        *slot = __uint_as_float(mxb);
      }
    }
    if constexpr (KIND == LOCAL) {
      // the row sums travel one diagonal late, off the critical path
      if (d > 0) {
        const float ws = warp_sum(rs_prev);
        if (wl == 0)
          *at_rank<CLUSTER>(ring_rs + ((d - 1) & (RING - 1)) * R +
                                rank * nw + warp, 0) = ws;
      }
      rs_prev = rs;
    }
    block_sync<CLUSTER>();

    const float4* r4 = reinterpret_cast<const float4*>(red + par * 64);
    float mx = 0.f;
    for (int q = 0; q < (R + 3) / 4; ++q) {
      const float4 v = r4[q];
      mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    }
    const float e = floor_log2(mx);
    const float f = exp2i(-e);
    const float s_new = s1 - e;
    if (lead) {
      scales[((size_t)mi * D + d) * B + b] = s_new;
      if constexpr (KIND == LOCAL) {
        ring_fs[(d & (RING - 1)) * 2] = f;
        ring_fs[(d & (RING - 1)) * 2 + 1] = s_new;
      }
    }
    if constexpr (KIND == LOCAL) {
      if (rank == 0 && warp == 0 && d >= 32 && (d & 31) == 0)
        acc = fold_rows(acc, d - 32, d, ring_rs, ring_fs, R);
    }

    // the scaled states: a lane reads back M and the X states (hmm5,
    // local), Zm and Zf (partition) itself; all of them form the sums
    // its right neighbour reads
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
#pragma unroll
      for (int s = 0; s < NS; ++s) st[k][s] = nv[k][s] * f;
    }
    // the plane row: through the warp's staging row, 32 consecutive
    // floats a store
    float* prow = planes + (((size_t)mi * D + d) * B + b) * W;
#pragma unroll
    for (int q = 0; q < LPT / 4; ++q) {
      float4 v4;
      if constexpr (EMIT) {
        v4 = make_float4(amv[4 * q] * f, amv[4 * q + 1] * f,
                         amv[4 * q + 2] * f, amv[4 * q + 3] * f);
      } else {
        v4 = make_float4(st[4 * q][0], st[4 * q + 1][0], st[4 * q + 2][0],
                         st[4 * q + 3][0]);
      }
      reinterpret_cast<float4*>(stage)[wl * (LPT / 4) + q] = v4;
    }
    if (lead) {
#pragma unroll
      for (int s = 0; s < NS; ++s) st0[s] = nv0[s] * f;
      prow[0] = EMIT ? am0 * f : st0[0];
    }
    __syncwarp();
    const int jw = 1 + rank * P.span + warp * 32 * LPT;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = jw + k * 32 + wl;
      if (j < W) prow[j] = stage[k * 32 + wl];
    }
    if constexpr (KIND != LOCAL) {
      if (d == dterm) {
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          if (j0 + k == jt) {
            // the terminal cell: the model's log2 total
            float tot;
            if constexpr (KIND == HMM5) {
              tot = 0.f;
#pragma unroll
              for (int s = 0; s < 5; ++s)
                tot = tot + (nv[k][s] * f) * M.init[s];
            } else {
              tot = (nv[k][0] * f + nv[k][1] * f) + nv[k][2] * f;
            }
            l2t[(size_t)mi * B + b] = log2f(fmaxf(tot, TINY)) - s_new;
          }
        }
      }
    }

    // each lane's left-neighbour sums, from the neighbour's scaled
    // states: in this thread; from the thread to the left (shuffled
    // above); across a warp edge from the edge slot
    const float* es = edge + (par * MAX_WARPS + warp) * 8;
#pragma unroll
    for (int k = LPT - 1; k > 0; --k) {
      a_cur[k] = a_next[k];
      sums<KIND>(M, st[k - 1], a_next[k], b1s[k], b2s[k]);
    }
    float lst[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) lst[s] = (wl ? left[s] : es[s]) * f;
    a_cur[0] = a_next[0];
    sums<KIND>(M, lst, a_next[0], b1s[0], b2s[0]);
    rc = f;
    s1 = s_new;
  }

  if constexpr (KIND == LOCAL) {
    // the last diagonal's row sums, then the diagonals not folded yet
    const float ws = warp_sum(rs_prev);
    if (wl == 0)
      *at_rank<CLUSTER>(ring_rs + ((D - 1) & (RING - 1)) * R + rank * nw +
                            warp, 0) = ws;
    block_sync<CLUSTER>();
    if (rank == 0 && warp == 0) {
      const int lo = (D - 1) / 32 * 32;
      acc = fold_rows(acc, lo, D, ring_rs, ring_fs, R);
      if (lead) l2t[(size_t)mi * B + b] = acc;
    }
  }
  // no block of a cluster leaves while another may still write into it
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

template <bool EMIT, bool CLUSTER, int LPT>
__global__ void __launch_bounds__(MAX_THREADS)
    sweep_kernel(const int8_t* X, const int8_t* Y, const int32_t* ox,
                 const int32_t* oy, const int32_t* lx, const int32_t* ly,
                 const float* tabs, int k0, int k1, int k2, int B, int Lp,
                 float* planes, float* scales, float* l2t) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan P = make_plan<LPT>(Lp + 1);
  const int rank = blockIdx.x % P.cl, b = blockIdx.x / P.cl;
  const int mi = blockIdx.y;
  const int kind = mi == 0 ? k0 : (mi == 1 ? k1 : k2);
  const float* tab = tabs + (size_t)mi * TAB_SIZE;
  if (kind == HMM5)
    sweep_one<HMM5, EMIT, CLUSTER, LPT>(X, Y, ox[b], oy[b], lx[b], ly[b],
                                        tab, B, Lp, b, mi, rank, P, planes,
                                        scales, l2t, smem);
  else if (kind == LOCAL)
    sweep_one<LOCAL, EMIT, CLUSTER, LPT>(X, Y, ox[b], oy[b], lx[b], ly[b],
                                         tab, B, Lp, b, mi, rank, P, planes,
                                         scales, l2t, smem);
  else
    sweep_one<PARTITION, EMIT, CLUSTER, LPT>(X, Y, ox[b], oy[b], lx[b],
                                             ly[b], tab, B, Lp, b, mi, rank,
                                             P, planes, scales, l2t, smem);
}

template <bool EMIT, bool CLUSTER, int LPT>
cudaError_t launch(const int8_t* X, const int8_t* Y, const int32_t* ox,
                   const int32_t* oy, const int32_t* lx, const int32_t* ly,
                   const float* tabs, int nm, int k0, int k1, int k2, int B,
                   int Lp, float* planes, float* scales, float* l2t,
                   cudaStream_t stream) {
  const Plan P = make_plan<LPT>(Lp + 1);
  const size_t smem = smem_layout<LPT>(Lp, P).total_bytes;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = sweep_kernel<EMIT, CLUSTER, LPT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * P.cl, nm);
  cfg.blockDim = dim3(P.nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, X, Y, ox, oy, lx, ly, tabs,
                                       k0, k1, k2, B, Lp, planes, scales,
                                       l2t);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int sweep_launch(const void* X, const void* Y, const void* ox,
                            const void* oy, const void* lx, const void* ly,
                            const void* tabs, int nm, int k0, int k1, int k2,
                            int B, int Lp, int emit_pre, void* planes,
                            void* scales, void* l2t, void* stream) {
  const int W = Lp + 1;
  if (Lp < 0 || W - 1 > MAX_CLUSTER * MAX_THREADS * LPT_LONG || nm < 1 ||
      nm > 3 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto* x = (const int8_t*)X;
  auto* y = (const int8_t*)Y;
  auto* a = (const int32_t*)ox;
  auto* c = (const int32_t*)oy;
  auto* e = (const int32_t*)lx;
  auto* g = (const int32_t*)ly;
  auto* t = (const float*)tabs;
  auto* p = (float*)planes;
  auto* s = (float*)scales;
  auto* l = (float*)l2t;
  auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (W - 1 > MAX_CLUSTER * MAX_THREADS * LPT_SHORT) {
    // past 8,192 lanes: always a cluster (8,192 lanes a block at most)
    err = emit_pre ? launch<true, true, LPT_LONG>(x, y, a, c, e, g, t, nm, k0,
                                                  k1, k2, B, Lp, p, s, l, st)
                   : launch<false, true, LPT_LONG>(x, y, a, c, e, g, t, nm,
                                                   k0, k1, k2, B, Lp, p, s, l,
                                                   st);
    return (int)err;
  }
  const bool cluster = make_plan<LPT_SHORT>(W).cl > 1;
  if (emit_pre)
    err = cluster ? launch<true, true, LPT_SHORT>(x, y, a, c, e, g, t, nm, k0,
                                                  k1, k2, B, Lp, p, s, l, st)
                  : launch<true, false, LPT_SHORT>(x, y, a, c, e, g, t, nm,
                                                   k0, k1, k2, B, Lp, p, s, l,
                                                   st);
  else
    err = cluster ? launch<false, true, LPT_SHORT>(x, y, a, c, e, g, t, nm,
                                                   k0, k1, k2, B, Lp, p, s, l,
                                                   st)
                  : launch<false, false, LPT_SHORT>(x, y, a, c, e, g, t, nm,
                                                    k0, k1, k2, B, Lp, p, s,
                                                    l, st);
  return (int)err;
}
