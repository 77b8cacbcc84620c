// Posterior combine + MWT accuracy DP (+ fused per-diagonal top-k).
//
// Replaces the Pallas TPU kernel `combine` (mlprobs_tpu/ops/pallas/
// wavefront_kernel.py, `combine` / `_combine_kernel_body`).  Same
// contract as the plain PyTorch version (ops/wavefront.py
// `posterior_skew` per model, RMS, `mwt_skew`, `topk_skew`): from the
// forward and reverse sweeps, the skewed posterior plane of every pair,
// its MWT score at (lx, ly), optionally the number of diagonal moves on
// the MWT path, and either the dense (D, B, W) plane or per diagonal the
// top k values >= cutoff with their lanes.
//
// Arithmetic.  Per model, p = (f * pa) * (r * pb) * c: the exponent
// sf + sr + l2t is split in two powers of two applied to f and to r
// before the product, so tiny x huge cells neither under- nor overflow,
// and the only inexact factor is c, one exp2 of the fractional part per
// diagonal.  r is the reverse plane's row 2Lp+2-d at lane Lp+1-j.  Totals:
// hmm5 and local average the forward and reverse totals, partition takes
// the forward one.  p is clamped to 1, the models combine by RMS, and the
// MWT step breaks ties diag >= left >= up.  Built with --fmad=false, so
// every product and sum rounds as the plain version's; the RMS's division
// and square root round as the plain version's too, through branch-free
// sequences (`div_models`, `sqrt_rn`).
//
// What bounds it on the H100: bytes.  Each cell of the 2 * nm input
// planes is read once and the dense plane written once (3.77 GB, 1.13 ms
// at mix, Lp = 512, B = 256), against a few dozen f32 operations a cell.
// Only the MWT DP is a chain: diagonal d needs the values of d - 1 and
// d - 2, so a pair's 2Lp+1 diagonals run in turn.  The posterior of a
// diagonal needs nothing of its neighbours.  A block that walks all its
// lanes through the diagonals in lockstep puts every load, the posterior
// arithmetic and the row store on that chain, and then pays microseconds
// a diagonal however far ahead its loads are issued.  This kernel keeps
// them off it.
//
// Layout: one block per pair, two kinds of warps.
// - P producer warps (7 at Lp <= 512, else 8) take whole diagonals in
//   turn (warp w: d = w, w + P, ...).  The 32 lanes of a warp stride over
//   the row, so every load and store covers consecutive addresses, and a
//   lane has 16 lanes' worth of the 2 * nm rows in flight at once (8 in
//   the top-k mode): up to Lp = 512 a diagonal costs a warp one round
//   trip to device memory, and across the producers the loads of up to P
//   diagonals are in flight while the DP works on an earlier one.  A warp
//   computes its diagonal's scale factors itself (lane m for model m, the
//   scales loaded one turn ahead, shuffled to the warp), writes the
//   posterior row into a ring of R rows in shared memory and, in the dense
//   mode, straight to the output plane.
// - G DP warps (one per 32 * LPT lanes; LPT = 16 up to Lp = 4,096, else
//   32) run the MWT DP over the ring's rows in diagonal order, LPT
//   contiguous lanes a thread: the j-1 neighbour is a register inside a
//   thread, a shuffle between threads, and one shared slot per warp edge
//   between DP warps, published by one named barrier of the DP warps a
//   diagonal.  Up to Lp = 512 one DP warp holds the whole pair, and the
//   chain has no barrier at all.
// - Past Lp = 8,192 (sequences of more than 8,192 residues) the 8 DP
//   warps walk the row in T tiles of 4,096 lanes, 16 lanes a thread in
//   each: tile t of warp g holds lanes 1 + 16 * ((t * 8 + g) * 32 + l)
//   onwards.  A thread keeps the DP state of its T tiles in local memory
//   (the L1 and L2 caches) and brings one tile at a time into registers;
//   the j-1 neighbour of a tile's first lane crosses warps, and from the
//   last warp into the next tile, through one shared slot per chunk of
//   512 lanes.  The diagonal still needs only d - 1 and d - 2, so the
//   tiles of a diagonal run in any order, and one barrier a diagonal
//   still publishes every edge.  The ring then takes all of a block's
//   shared memory: 4 rows (so 4 producers) up to Lp = 12,288, 3 at
//   Lp = 16,384.
// The ring is the pipeline: a row is handed over by two mbarriers, `full`
// (the producer's 32 lanes arrive after writing it) and `empty` (the DP
// lanes arrive after reading it), so a producer runs up to R diagonals
// ahead of the DP and waits only when the ring is full.  R (2 to 16 rows)
// is chosen at launch so that two blocks fit an SM where they can, and a
// block has no more producers than ring rows.
//
// Alignment.  A row of W = Lp + 1 floats starts on a 4-byte boundary
// only, so every global access is a plain 4-byte load or store, never a
// vector or bulk copy, and nothing is read past a row's end.  In the
// ring, lane j sits at index j + 3 of its row, so that a DP thread's
// lanes 1 + LPT * t ... start on 16 bytes and are read as float4s.
//
// Top-k with no block barrier.  The producer warp of a diagonal ranks its
// own row: while it computes the row it compacts the lanes >= cutoff into
// a per-warp candidate list (ballot and popc), and each candidate's rank
// is the number of candidates that are larger, or equal at a lower lane,
// which is the order of the JAX package's top_k.  The ranks below k are
// written, then zeros to the empty slots.  Up to 32 candidates (the match
// posteriors of an anti-diagonal sum to at most 1 a model, so at cutoff
// 0.01 there are rarely more than 20) the ranking is one lane a candidate
// and a shuffle per candidate; with more, the warp takes the top k from
// the ring row in k rounds of a warp-wide arg-max, in the same order, so
// no bound on the count is assumed.  The posterior plane never reaches
// device memory in this mode.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int PARTITION = 2;
constexpr float TINY = 1e-38f;  // the plain version's floor for log2
constexpr int MAX_DP_WARPS = 8;
constexpr int MAX_PRODUCERS = 8;
constexpr int MAX_RING = 16;
// the tiled DP (Lp > MAX_DP_WARPS * 32 * 32): lanes a thread in a tile,
// and tiles at most
constexpr int TILE_LPT = 16;
constexpr int MAX_TILES = 16;
constexpr int MAX_CHUNKS = MAX_TILES * MAX_DP_WARPS;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can have
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float pow2i(float e) {
  // exact 2**e for integer-valued e, clamped to the normal range
  int ei = (int)fminf(fmaxf(e, -126.f), 127.f);
  return __int_as_float((ei + 127) << 23);
}

// x / n for 0 <= x <= n, rounded as the division is, without a branch:
// x * 0.5 is x / 2 exactly, and one FMA correction of x * RN(1/3) gives
// RN(x / 3) for every float in [0, 3] (checked against the division for
// all of them)
template <int N>
__device__ __forceinline__ float div_models(float x) {
  if constexpr (N == 1) return x;
  if constexpr (N == 2) return x * 0.5f;
  const float r3 = __int_as_float(0x3eaaaaab);  // RN(1/3)
  const float q = x * r3;
  return fmaf(fmaf(-3.f, q, x), r3, q);
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sqrt(x) rounded to nearest for 0 <= x < 4, without a branch (the
// library's sqrtf branches to a slow path for 0 and subnormals, which
// serialises a warp's cells).  One Newton step from the approximate
// reciprocal root lands within an ulp; the sign of x - s * s' (exact in
// an FMA) for the neighbours s' of s then picks the rounded root.
// Inputs below 2^-64 are scaled by 2^64 first, so the residuals stay
// representable.  Checked against sqrtf for every float in [0, 4).
__device__ __forceinline__ float sqrt_rn(float x) {
  const bool tiny = x < 0x1p-64f;
  const float xs = tiny ? x * 0x1p64f : x;
  const float y = rsqrt_approx(xs);
  float s = xs * y;
  s = fmaf(fmaf(-s, s, xs), 0.5f * y, s);
  const float su = __int_as_float(__float_as_int(s) + 1);
  const float sd = __int_as_float(__float_as_int(s) - 1);
  s = fmaf(-s, su, xs) > 0.f ? su : (fmaf(-sd, s, xs) <= 0.f ? sd : s);
  s = tiny ? s * 0x1p-32f : s;
  return xs == 0.f ? 0.f : s;
}

// the diagonal's split power-of-two factors of one model: pa, pb, c.
// Each of pa and pb carries at most 2^127 (2^-126); what they cannot
// carry of 2^-ti (|t| past 253, a tiny f times a tiny r on a long pair)
// scales c, exactly, so that p keeps the plain version's value.
__device__ __forceinline__ float4 factors(float sf, float sr, float l2t) {
  const float t = sf + sr + l2t;
  const float ti = floorf(t);
  const float a = fminf(fmaxf(floorf(-ti * 0.5f), -126.f), 127.f);
  const float b2 = fminf(fmaxf(-ti - a, -126.f), 127.f);
  return make_float4(pow2i(a), pow2i(b2),
                     exp2f(-(t - ti)) * pow2i(-ti - a - b2), 0.f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_done(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_done(bar, parity)) {
  }
}

// named barrier 1 among the first `n` threads (the DP warps)
__device__ __forceinline__ void dp_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

struct Args {
  const float *fwd, *fsc, *fl2t, *rev, *rsc, *rl2t;
  const int32_t *lx, *ly;
  int k0, k1, k2, B, Lp, topk;
  float cutoff;
  float *post, *vals;
  int32_t* lanes;
  float *score, *nb;
};

// Shared memory, in this order: the ring (R rows of `ring_row` floats),
// the barriers (full[R], empty[R]), the DP warps' edge slots
// ([2][MAX_DP_WARPS] float2), the producers' top-k candidates
// ([MAX_PRODUCERS][32] values, then as many lanes).
__host__ __device__ inline int ring_row(int G, int lpt) {
  return G * 32 * lpt + 4;
}

__host__ __device__ inline size_t smem_bytes(int G, int lpt, int R) {
  return (size_t)R * ring_row(G, lpt) * 4 + 2 * R * 8 +
         2 * MAX_DP_WARPS * 8 + 2 * MAX_PRODUCERS * 32 * 4;
}

// The top k of a ring row (lane j at row[j]) into vrow / lrow, by one
// warp in k rounds: each round takes the largest (value, lowest lane)
// that comes after the last one taken, among the values >= cutoff, and
// the first round with nothing left fills the remaining slots with zeros.
__device__ void select_topk(const float* row, int W, int k, float cutoff,
                            float* vrow, int32_t* lrow) {
  const int l = threadIdx.x & 31;
  float pv = INFINITY;  // the last (value, lane) taken
  int pl = -1;
  for (int t = 0; t < k; ++t) {
    float bv = 0.f;
    int bl = 0x7fffffff;
    for (int j = 1 + l; j < W; j += 32) {
      const float v = row[j];
      const bool after = v < pv || (v == pv && j > pl);
      if (v >= cutoff && v > 0.f && after && v > bv) {
        bv = v;  // j rises, so among equal values the lowest lane stays
        bl = j;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
      const int ol = __shfl_xor_sync(FULL_MASK, bl, o);
      if (ov > bv || (ov == bv && ol < bl)) {
        bv = ov;
        bl = ol;
      }
    }
    if (!(bv > 0.f)) {
      for (int q = t + l; q < k; q += 32) {
        vrow[q] = 0.f;
        lrow[q] = 0;
      }
      return;
    }
    if (l == 0) {
      vrow[t] = bv;
      lrow[t] = bl;
    }
    pv = bv;
    pl = bl;
  }
}

// Producer warp pw of P: the posterior rows of diagonals pw, pw + P, ...
// A lane has UNROLL lanes' rows in flight: 16 (all of a row up to Lp =
// 512, one round trip a diagonal) in the dense mode, 8 in the top-k mode,
// whose candidate list would otherwise spill.
template <int NM, bool TOPK>
__device__ void produce(const Args& a, int pw, int P, int R, int rowf,
                        float* ring, uint64_t* full, uint64_t* empty,
                        float* cand_v, int* cand_l) {
  const int l = threadIdx.x & 31;
  const int Lp = a.Lp, B = a.B, W = Lp + 1, D = 2 * Lp + 1;
  const int b = blockIdx.x;
  constexpr int UNROLL = TOPK ? 8 : 16;
  // lane m < NM: model m's total, and its scales one turn ahead
  float l2t = 0.f, sf = 0.f, sr = 0.f;
  if (l < NM) {
    const int kind = l == 0 ? a.k0 : (l == 1 ? a.k1 : a.k2);
    const float f = a.fl2t[(size_t)l * B + b];
    l2t = kind == PARTITION ? f : 0.5f * (f + a.rl2t[(size_t)l * B + b]);
  }
  auto load_scales = [&](int d) {
    if (l < NM && d < D) {
      const int rr = 2 * Lp + 2 - d;
      sf = a.fsc[((size_t)l * D + d) * B + b];
      sr = rr < D ? a.rsc[((size_t)l * D + rr) * B + b] : 0.f;
    }
  };
  load_scales(pw);
  for (int d = pw; d < D; d += P) {
    const int s = d % R, use = d / R;
    const float4 fl = factors(sf, sr, l2t);
    load_scales(d + P);
    float pa[NM], pb[NM], cc[NM];
    const float* frow[NM];
    const float* rrow[NM];
    const int rr = 2 * Lp + 2 - d;
    const bool has_rev = rr < D;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      pa[m] = __shfl_sync(FULL_MASK, fl.x, m);
      pb[m] = __shfl_sync(FULL_MASK, fl.y, m);
      cc[m] = __shfl_sync(FULL_MASK, fl.z, m);
      frow[m] = a.fwd + (((size_t)m * D + d) * B + b) * W;
      // the reverse row is read at lane Lp + 1 - j
      rrow[m] = has_rev ? a.rev + (((size_t)m * D + rr) * B + b) * W + Lp + 1
                        : frow[m];
    }
    float* out = TOPK ? nullptr : a.post + ((size_t)d * B + b) * W;
    if (!TOPK && l == 0) out[0] = 0.f;  // lane 0 is outside the grid
    float* row = ring + (size_t)s * rowf + 3;  // lane j at row[j]
    int ncand = 0;
    // lanes 1 .. Lp, 32 * UNROLL at a time (j0 is the same in the warp)
    for (int j0 = 1; j0 < W; j0 += 32 * UNROLL) {
      float fv[UNROLL][NM], rv[UNROLL][NM];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 32 * u + l;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          fv[u][m] = j < W ? frow[m][j] : 0.f;
          rv[u][m] = has_rev && j < W ? rrow[m][-j] : 0.f;
        }
      }
      // the DP has read the row this one overwrites
      if (j0 == 1 && use > 0) mbar_wait(empty + s, (use - 1) & 1);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 32 * u + l;
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const float f = fv[u][m], r = rv[u][m];
          // a subnormal plane value counts as TINY, as in the plain
          // version's log2(max(f, TINY))
          float p = (fmaxf(f, TINY) * pa[m]) * (fmaxf(r, TINY) * pb[m]) * cc[m];
          p = fminf(p, 1.f);
          p = (f > 0.f && r > 0.f) ? p : 0.f;
          acc = m == 0 ? p * p : acc + p * p;
        }
        const float post = sqrt_rn(div_models<NM>(acc));
        if (j < W) {
          row[j] = post;
          if constexpr (!TOPK) out[j] = post;
        }
        if constexpr (TOPK) {
          const bool c = j < W && post >= a.cutoff && post > 0.f;
          const unsigned bal = __ballot_sync(FULL_MASK, c);
          const int pos = ncand + __popc(bal & ((1u << l) - 1u));
          if (c && pos < 32) {
            cand_v[pos] = post;
            cand_l[pos] = j;
          }
          ncand += __popc(bal);
        }
      }
    }
    if constexpr (TOPK) {
      float* vrow = a.vals + ((size_t)d * B + b) * a.topk;
      int32_t* lrow = a.lanes + ((size_t)d * B + b) * a.topk;
      __syncwarp();
      if (ncand <= 32) {
        // one lane a candidate: its rank among all of them
        const float v = l < ncand ? cand_v[l] : 0.f;
        const int jl = l < ncand ? cand_l[l] : 0;
        int rank = 0;
        for (int i = 0; i < ncand; ++i) {
          const float v2 = __shfl_sync(FULL_MASK, v, i);
          const int j2 = __shfl_sync(FULL_MASK, jl, i);
          rank += (v2 > v || (v2 == v && j2 < jl)) ? 1 : 0;
        }
        if (l < ncand && rank < a.topk) {
          vrow[rank] = v;
          lrow[rank] = jl;
        }
        for (int q = ncand + l; q < a.topk; q += 32) {
          vrow[q] = 0.f;
          lrow[q] = 0;
        }
      } else {
        select_topk(row, W, a.topk, a.cutoff, vrow, lrow);
      }
      __syncwarp();  // the list is this warp's again next turn
    }
    mbar_arrive(full + s);  // each lane after its own writes
  }
}

// The tiled DP (Lp > 8,192): DP warp g of G takes chunk c = t * G + g of
// every tile t, lanes 1 + LPT * (32 * c + l) ... of its thread; the state
// of the thread's T tiles lives in local memory between diagonals.  The
// step is mwt's, cell for cell.
template <int LPT, bool WM>
__device__ void mwt_tiled(const Args& a, int g, int G, int T, int R,
                          int rowf, const float* ring, uint64_t* full,
                          uint64_t* empty, float2* edge) {
  const int l = threadIdx.x & 31;
  const int Lp = a.Lp, W = Lp + 1, D = 2 * Lp + 1;
  const int b = blockIdx.x;
  const int ly = a.ly[b], dterm = a.lx[b] + ly;
  const int nc = T * G;  // chunks of 32 * LPT lanes
  float S1[MAX_TILES][LPT], S2[MAX_TILES][LPT];
  float N1[MAX_TILES][LPT], N2[MAX_TILES][LPT];
  float L2[MAX_TILES], NL2[MAX_TILES];  // s, n of (d-2, j0-1) a tile
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      S1[t][k] = S2[t][k] = N1[t][k] = N2[t][k] = 0.f;
    L2[t] = NL2[t] = 0.f;
  }
  float sc = 0.f, nbv = 0.f;
  int s = 0;
  unsigned ph = 0;
  for (int d = 0; d < D; ++d) {
    const int par = d & 1;
    mbar_wait(full + s, ph);
    const float* rowd = ring + (size_t)s * rowf + 3;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const int c = t * G + g;
      const int j0 = 1 + (c * 32 + l) * LPT;
      float s1[LPT], s2[LPT], n1[LPT], n2[LPT], pv[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        s1[k] = S1[t][k];
        s2[k] = S2[t][k];
        n1[k] = WM ? N1[t][k] : 0.f;
        n2[k] = WM ? N2[t][k] : 0.f;
      }
      // (d-1, j0-1): from the thread to the left, or the chunk's edge slot
      float l1 = __shfl_up_sync(FULL_MASK, s1[LPT - 1], 1);
      float nl1 = 0.f;
      if constexpr (WM) nl1 = __shfl_up_sync(FULL_MASK, n1[LPT - 1], 1);
      if (l == 0) {
        const float2 e = c == 0 ? make_float2(0.f, 0.f)
                                : edge[(par ^ 1) * MAX_CHUNKS + c];
        l1 = e.x;
        nl1 = e.y;
      }
      const float l2 = L2[t], nl2 = NL2[t];
      const float* row = rowd + j0;  // 16-byte aligned
#pragma unroll
      for (int q = 0; q < LPT / 4; ++q) {
        const float4 x = reinterpret_cast<const float4*>(row)[q];
        pv[4 * q] = x.x;
        pv[4 * q + 1] = x.y;
        pv[4 * q + 2] = x.z;
        pv[4 * q + 3] = x.w;
      }
      float sn[LPT], nn[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = j0 + k;
        const float p = j < W ? pv[k] : 0.f;  // past W the row holds junk
        const float left = k ? s1[k - 1] : l1;
        const float pd = p + (k ? s2[k - 1] : l2);
        const float up = s1[k];
        const bool take_d = pd >= left && pd >= up;
        const bool take_l = left >= up;
        const bool boundary = d <= j;  // i = d - j <= 0 (j >= 1 here)
        sn[k] = boundary ? 0.f : (take_d ? pd : (take_l ? left : up));
        nn[k] = 0.f;
        if constexpr (WM) {
          const float nd = (k ? n2[k - 1] : nl2) + 1.f;
          const float nlft = k ? n1[k - 1] : nl1;
          nn[k] = boundary ? 0.f : (take_d ? nd : (take_l ? nlft : n1[k]));
        }
      }
      if (d == dterm) {
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          if (j0 + k == ly) {
            sc = sn[k];
            nbv = nn[k];
          }
      }
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        S2[t][k] = s1[k];
        S1[t][k] = sn[k];
        if constexpr (WM) {
          N2[t][k] = n1[k];
          N1[t][k] = nn[k];
        }
      }
      L2[t] = l1;
      NL2[t] = nl1;
      if (l == 31 && c + 1 < nc)
        edge[par * MAX_CHUNKS + c + 1] = make_float2(sn[LPT - 1], nn[LPT - 1]);
    }
    mbar_arrive(empty + s);  // each lane after its own reads
    s = s + 1 == R ? 0 : s + 1;
    if (s == 0) ph ^= 1u;
    dp_sync(32 * G);
  }
  const int q = ly >= 1 ? (ly - 1) / LPT : 0;  // thread-lane of lane ly
  if ((q >> 5) % G == g && (q & 31) == l) {
    a.score[b] = sc;
    if (WM) a.nb[b] = nbv;
  }
}

// DP warp g of G: the MWT DP over lanes 1 + 32 * LPT * g ... of every
// diagonal, in order, from the ring.
template <int LPT, bool WM>
__device__ void mwt(const Args& a, int g, int G, int R, int rowf,
                    const float* ring, uint64_t* full, uint64_t* empty,
                    float2* edge) {
  const int l = threadIdx.x & 31;
  const int Lp = a.Lp, W = Lp + 1, D = 2 * Lp + 1;
  const int b = blockIdx.x;
  const int ly = a.ly[b], dterm = a.lx[b] + ly;
  const int j0 = 1 + (g * 32 + l) * LPT;  // this thread's lanes
  float s1[LPT], s2[LPT], n1[LPT], n2[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) s1[k] = s2[k] = n1[k] = n2[k] = 0.f;
  float l2 = 0.f, nl2 = 0.f;  // s, n of (d-2, j0-1)
  float sc = 0.f, nbv = 0.f;
  int s = 0;
  unsigned ph = 0;  // ring row of diagonal d and its barrier phase parity
  for (int d = 0; d < D; ++d) {
    const int par = d & 1;
    // (d-1, j0-1): from the thread to the left, or across a warp edge
    float l1 = __shfl_up_sync(FULL_MASK, s1[LPT - 1], 1);
    float nl1 = 0.f;
    if constexpr (WM) nl1 = __shfl_up_sync(FULL_MASK, n1[LPT - 1], 1);
    if (l == 0) {
      const float2 e = g == 0 ? make_float2(0.f, 0.f)
                              : edge[(par ^ 1) * MAX_DP_WARPS + g];
      l1 = e.x;
      nl1 = e.y;
    }
    float pv[LPT];
    mbar_wait(full + s, ph);
    const float* row = ring + (size_t)s * rowf + 3 + j0;  // 16-byte aligned
#pragma unroll
    for (int q = 0; q < LPT / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(row)[q];
      pv[4 * q] = x.x;
      pv[4 * q + 1] = x.y;
      pv[4 * q + 2] = x.z;
      pv[4 * q + 3] = x.w;
    }
    mbar_arrive(empty + s);  // each lane after its own reads
    s = s + 1 == R ? 0 : s + 1;
    if (s == 0) ph ^= 1u;

    // MWT accuracy DP (tie order diag >= left >= up)
    float sn[LPT], nn[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = j0 + k;
      const float p = j < W ? pv[k] : 0.f;  // past W the row holds junk
      const float left = k ? s1[k - 1] : l1;
      const float pd = p + (k ? s2[k - 1] : l2);
      const float up = s1[k];
      const bool take_d = pd >= left && pd >= up;
      const bool take_l = left >= up;
      const bool boundary = d <= j;  // i = d - j <= 0 (j >= 1 here)
      sn[k] = boundary ? 0.f : (take_d ? pd : (take_l ? left : up));
      nn[k] = 0.f;
      if constexpr (WM) {
        const float nd = (k ? n2[k - 1] : nl2) + 1.f;
        const float nlft = k ? n1[k - 1] : nl1;
        nn[k] = boundary ? 0.f : (take_d ? nd : (take_l ? nlft : n1[k]));
      }
    }
    if (d == dterm) {
#pragma unroll
      for (int k = 0; k < LPT; ++k)
        if (j0 + k == ly) {
          sc = sn[k];
          nbv = nn[k];
        }
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      s2[k] = s1[k];
      s1[k] = sn[k];
      if constexpr (WM) {
        n2[k] = n1[k];
        n1[k] = nn[k];
      }
    }
    l2 = l1;
    nl2 = nl1;
    if (G > 1) {
      if (l == 31 && g + 1 < G)
        edge[par * MAX_DP_WARPS + g + 1] =
            make_float2(sn[LPT - 1], nn[LPT - 1]);
      dp_sync(32 * G);
    }
  }
  const int owner = ly >= 1 ? (ly - 1) / LPT : 0;  // thread of lane ly
  if (g * 32 + l == owner) {
    a.score[b] = sc;
    if (WM) a.nb[b] = nbv;
  }
}

// warps 0 .. G-1 run the DP, the rest produce posterior rows; TILED:
// the DP in T tiles, its edge slots after the candidate lists
template <int NM, int LPT, bool TOPK, bool WM, bool TILED>
__global__ void __launch_bounds__(512)
    combine_kernel(const Args a, int G, int R, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rowf = ring_row(TILED ? G * T : G, LPT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)R * rowf);
  uint64_t* empty = full + R;
  float2* edge = reinterpret_cast<float2*>(empty + R);
  float* cand_v = reinterpret_cast<float*>(edge + 2 * MAX_DP_WARPS);
  int* cand_l = reinterpret_cast<int*>(cand_v + MAX_PRODUCERS * 32);
  const int warp = threadIdx.x >> 5;
  const int P = (int)(blockDim.x >> 5) - G;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 32 * G);
    }
    mbar_fence_init();
  }
  float2* tedge = reinterpret_cast<float2*>(cand_l + MAX_PRODUCERS * 32);
  if (threadIdx.x < 2 * MAX_DP_WARPS)
    edge[threadIdx.x] = make_float2(0.f, 0.f);
  if constexpr (TILED) {
    for (int k = threadIdx.x; k < 2 * MAX_CHUNKS; k += blockDim.x)
      tedge[k] = make_float2(0.f, 0.f);
  }
  __syncthreads();
  if (warp < G) {
    if constexpr (TILED)
      mwt_tiled<LPT, WM>(a, warp, G, T, R, rowf, smem, full, empty, tedge);
    else
      mwt<LPT, WM>(a, warp, G, R, rowf, smem, full, empty, edge);
  } else {
    const int pw = warp - G;
    produce<NM, TOPK>(a, pw, P, R, rowf, smem, full, empty,
                      cand_v + pw * 32, cand_l + pw * 32);
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

template <int NM, int LPT, bool TOPK, bool WM, bool TILED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // TILED: all DP warps, T tiles of them across the row
  const int G = TILED ? MAX_DP_WARPS
                      : std::max(1, (a.Lp + 32 * LPT - 1) / (32 * LPT));
  const int T = TILED ? (a.Lp + G * 32 * LPT - 1) / (G * 32 * LPT) : 1;
  if (T > MAX_TILES) return cudaErrorInvalidValue;
  const int GT = G * T;
  const size_t extra = TILED ? 2 * MAX_CHUNKS * 8 : 0;
  // the ring's depth: two blocks an SM where they fit, else one
  const int per_sm = device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor);
  const int reserved = device_attr(cudaDevAttrReservedSharedMemoryPerBlock);
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  auto depth = [&](int budget) {
    int R = MAX_RING;
    const int least = TILED ? 1 : 2;
    while (R > least && smem_bytes(GT, LPT, R) + extra > (size_t)budget) --R;
    return R;
  };
  // (TILED: one block an SM, and as many rows, so producers, as fit)
  int R = depth(TILED ? optin : per_sm / 2 - reserved);
  if (smem_bytes(GT, LPT, R) + extra > (size_t)(per_sm / 2 - reserved))
    R = depth(optin);
  // no more producers than ring rows: a producer then waits only for the
  // row of the diagonal R before its own, and an mbarrier's phase parity
  // never aliases (it would if the DP could be two uses of a row behind)
  const int P = std::min(G == 1 ? MAX_PRODUCERS - 1 : MAX_PRODUCERS, R);
  const size_t smem = smem_bytes(GT, LPT, R) + extra;
  if (smem > (size_t)std::min(optin, MAX_SMEM)) return cudaErrorInvalidValue;
  auto kern = combine_kernel<NM, LPT, TOPK, WM, TILED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<a.B, 32 * (G + P), smem, stream>>>(a, G, R, T);
  return cudaGetLastError();
}

template <int NM, int LPT, bool TILED>
cudaError_t launch_mode(const Args& a, bool with_matches,
                        cudaStream_t stream) {
  if (a.topk > 0)
    return with_matches ? launch<NM, LPT, true, true, TILED>(a, stream)
                        : launch<NM, LPT, true, false, TILED>(a, stream);
  return with_matches ? launch<NM, LPT, false, true, TILED>(a, stream)
                      : launch<NM, LPT, false, false, TILED>(a, stream);
}

template <int NM>
cudaError_t launch_lpt(const Args& a, bool with_matches,
                       cudaStream_t stream) {
  // at most MAX_DP_WARPS DP warps; past their 32 lanes a thread, tiles
  if (a.Lp <= MAX_DP_WARPS * 32 * 16)
    return launch_mode<NM, 16, false>(a, with_matches, stream);
  if (a.Lp <= MAX_DP_WARPS * 32 * 32)
    return launch_mode<NM, 32, false>(a, with_matches, stream);
  return launch_mode<NM, TILE_LPT, true>(a, with_matches, stream);
}

}  // namespace

extern "C" int combine_launch(const void* fwd, const void* fsc,
                              const void* fl2t, const void* rev,
                              const void* rsc, const void* rl2t,
                              const void* lx, const void* ly, int nm, int k0,
                              int k1, int k2, int B, int Lp,
                              int with_matches, int topk, float cutoff,
                              void* post, void* vals, void* lanes,
                              void* score, void* nb, void* stream) {
  const int W = Lp + 1;
  if (Lp < 0 || nm < 1 || nm > 3 || B < 1 || topk < 0 || topk > W)
    return (int)cudaErrorInvalidValue;
  const Args a = {(const float*)fwd, (const float*)fsc, (const float*)fl2t,
                  (const float*)rev, (const float*)rsc, (const float*)rl2t,
                  (const int32_t*)lx, (const int32_t*)ly, k0, k1, k2, B, Lp,
                  topk, cutoff, (float*)post, (float*)vals, (int32_t*)lanes,
                  (float*)score, (float*)nb};
  const auto st = (cudaStream_t)stream;
  const bool wm = with_matches != 0;
  cudaError_t err = nm == 1   ? launch_lpt<1>(a, wm, st)
                    : nm == 2 ? launch_lpt<2>(a, wm, st)
                              : launch_lpt<3>(a, wm, st);
  return (int)err;
}
