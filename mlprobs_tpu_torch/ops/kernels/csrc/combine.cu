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
// - G DP warps (one per 512 lanes, 16 lanes a thread) run the MWT DP
//   over the ring's rows in diagonal order, 16 contiguous lanes a thread:
//   the j-1 neighbour is a register inside a thread, a shuffle between
//   threads, and one shared slot per warp edge between DP warps, published
//   by one named barrier of the DP warps a diagonal.  Up to Lp = 512 one
//   DP warp holds the whole pair, and the chain has no barrier at all.
// - Past Lp = 4,096 one block no longer keeps up: a pair runs on a
//   cluster of up to 16 blocks (a non-portable cluster size, which the
//   H100 places on one GPC), block r owning the contiguous lanes lo_r ..
//   lo_r + span - 1, span = G * 32 * LPT with LPT = 4, 8 or 16 lanes a
//   thread, so every DP state stays in registers up to 65,536 lanes.  Its
//   producers compute only their block's cells of each diagonal into its
//   own ring (no cell needs its neighbours), so the reads spread over the
//   cluster's SMs, and its DP warps run the MWT over its lanes.  The j-1
//   edge of block r crosses to block r+1 through that block's shared
//   memory: an edge ring of XE slots, one a diagonal, with a count of the
//   diagonals delivered (a release store by the sender, polled with
//   acquire loads by the receiver) and one of the diagonals read, written
//   back every XE / 2.  No diagonal waits for a cluster barrier: block r+1
//   runs a hand-off behind block r, and only a full edge ring stops r.
//   The launch plan (instance, blocks a cluster, DP warps, lanes a thread,
//   producers, ring rows, shared bytes) comes from the wrapper
//   (ops/kernels/wavefront_kernel.py `combine_plan`), and the launcher
//   checks it against the layout below.
//
// The ring is the pipeline: a row is handed over by two mbarriers, `full`
// (the producer's 32 lanes arrive after writing it) and `empty` (the DP
// lanes arrive after reading it), so a producer runs up to R diagonals
// ahead of the DP and waits only when the ring is full.  R (1 to 16 rows)
// is chosen in the plan so that two one-block instances fit an SM where
// they can (a cluster's block takes an SM), and a block has no more
// producers than ring rows.
//
// Alignment.  A row of W = Lp + 1 floats starts on a 4-byte boundary
// only, so every global access is a plain 4-byte load or store, never a
// vector or bulk copy, and nothing is read past a row's end.  In the
// ring, lane j sits at index j - lo + 4 of its row (lo: the block's first
// DP lane, 1 in the one-block instance), so that a DP thread's lanes
// lo + LPT * t ... start on 16 bytes and are read as float4s.
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
// device memory in this mode.  In a cluster each block ranks its own
// lanes so into a list of at most k entries in device memory; after the
// last diagonal the cluster's warps take the diagonals in turn and rank
// the lists of all blocks together by the same rule (one lane an entry up
// to 32 entries in all, else a merge of the lists' heads).
//
// The GIVEN kind (the realigner's qp route, `mwt_topk` in
// ops/kernels/wavefront_kernel.py): the only model, it reads a (D, B, W)
// f32 posterior plane as it is, with no scales, RMS or clamp, and puts
// its rows into the ring; the DP warps and the top-k run on them
// unchanged, in either instance.  Over such a plane the MWT (the same
// adds and maxes, --fmad=false) and the top-k (copies of the values)
// equal `mwt_skew` and `topk_skew` bit for bit.  `topk_skew` ranks every lane of a row, lane 0
// too, so this kind ranks lane 0 as well.  The dense mode writes no
// plane: the caller holds it; only the score (and the match counts).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int PARTITION = 2;
constexpr int GIVEN = 3;  // a given posterior plane: the kernel's NM = 0
constexpr float TINY = 1e-38f;  // the plain version's floor for log2
constexpr int MAX_DP_WARPS = 8;
constexpr int MAX_PRODUCERS = 8;
constexpr int MAX_RING = 16;
constexpr int MAX_CLUSTER = 16;  // blocks a pair in the cluster instance
constexpr int XE = 32;           // a block edge's ring: diagonals in flight
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

// a count in shared memory that another block of the cluster writes
__device__ __forceinline__ unsigned ld_acquire_cluster(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cluster(unsigned* p, unsigned v) {
  asm volatile("st.release.cluster.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// p in the shared memory of block `rank` of this cluster
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

struct Args {
  const float *fwd, *fsc, *fl2t, *rev, *rsc, *rl2t;
  const int32_t *lx, *ly;
  int k0, k1, k2, B, Lp, topk;
  float cutoff;
  float *post, *vals;
  int32_t* lanes;
  float *score, *nb;
  // the cluster's top-k lists: (D, B, C) lists of kl values and lanes and
  // their lengths
  int kl;
  float* tkv;
  int32_t *tkl, *tkn;
};

// The lanes of one block: its pair b, its rank in the pair's cluster of
// C blocks (0 of 1 in the one-block instance), its first DP lane lo, and
// the lanes [pfirst, pend) its producers compute (lane 0 too in the GIVEN
// kind's first block).
struct Span {
  int b, rank, C, lo, pfirst, pend;
};

// Shared memory, in this order: the ring (R rows of `ring_row` floats),
// the barriers (full[R], empty[R]), the DP warps' edge slots
// ([2][MAX_DP_WARPS] float2), the producers' top-k candidates
// ([MAX_PRODUCERS][32] values, then as many lanes); in a cluster, the
// edge ring from the block to the left (XE float2) and two counts: its
// diagonals delivered, and the right block's diagonals read.
__host__ __device__ inline int ring_row(int G, int lpt) {
  return G * 32 * lpt + 4;
}

__host__ __device__ inline size_t smem_bytes(int G, int lpt, int R, bool cl) {
  return (size_t)R * ring_row(G, lpt) * 4 + 2 * R * 8 +
         2 * MAX_DP_WARPS * 8 + 2 * MAX_PRODUCERS * 32 * 4 +
         (cl ? XE * 8 + 16 : 0);
}

// The top k of a ring row (lane j at row[j]) into vrow / lrow, by one
// warp in k rounds: each round takes the largest (value, lowest lane)
// that comes after the last one taken, among the values >= cutoff, and
// the first round with nothing left fills the remaining slots with zeros.
// Lanes j0 .. jend-1 are ranked; returns the number of entries taken.
__device__ int select_topk(const float* row, int j0, int jend, int k,
                           float cutoff, float* vrow, int32_t* lrow) {
  const int l = threadIdx.x & 31;
  float pv = INFINITY;  // the last (value, lane) taken
  int pl = -1;
  for (int t = 0; t < k; ++t) {
    float bv = 0.f;
    int bl = 0x7fffffff;
    for (int j = j0 + l; j < jend; j += 32) {
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
      return t;
    }
    if (l == 0) {
      vrow[t] = bv;
      lrow[t] = bl;
    }
    pv = bv;
    pl = bl;
  }
  return k;
}

// Lane j's value v as a top-k candidate (c): compacted into the warp's
// list in lane order (ballot and popc); ncand counts every candidate.
__device__ __forceinline__ void push_candidate(bool c, float v, int j,
                                               int& ncand, float* cand_v,
                                               int* cand_l) {
  const int l = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(FULL_MASK, c);
  const int pos = ncand + __popc(bal & ((1u << l) - 1u));
  if (c && pos < 32) {
    cand_v[pos] = v;
    cand_l[pos] = j;
  }
  ncand += __popc(bal);
}

// The top k of a diagonal's lanes j0 .. jend-1 (its ring row, its ncand
// candidates) into vrow / lrow, by the producer warp; returns the number
// of entries written, min(ncand, k).
__device__ int write_topk(float* vrow, int32_t* lrow, int k, float cutoff,
                          const float* row, int j0, int jend, int ncand,
                          const float* cand_v, const int* cand_l) {
  const int l = threadIdx.x & 31;
  int n;
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
    if (l < ncand && rank < k) {
      vrow[rank] = v;
      lrow[rank] = jl;
    }
    for (int q = ncand + l; q < k; q += 32) {
      vrow[q] = 0.f;
      lrow[q] = 0;
    }
    n = ncand < k ? ncand : k;
  } else {
    n = select_topk(row, j0, jend, k, cutoff, vrow, lrow);
  }
  __syncwarp();  // the list is this warp's again next turn
  return n;
}

// Diagonal d's top k of the block's lanes (ring row `row`): straight to
// the output in the one-block instance; into the block's list in a
// cluster (merged after the last diagonal, `merge_topk`).
template <bool CL>
__device__ __forceinline__ void block_topk(const Args& a, const Span& sp,
                                           int d, const float* row,
                                           int ncand, const float* cand_v,
                                           const int* cand_l) {
  if constexpr (CL) {
    const size_t li = ((size_t)d * a.B + sp.b) * sp.C + sp.rank;
    const int n = write_topk(a.tkv + li * a.kl, a.tkl + li * a.kl, a.kl,
                             a.cutoff, row, sp.pfirst, sp.pend, ncand,
                             cand_v, cand_l);
    if ((threadIdx.x & 31) == 0) a.tkn[li] = n;
  } else {
    const size_t oi = ((size_t)d * a.B + sp.b) * a.topk;
    write_topk(a.vals + oi, a.lanes + oi, a.topk, a.cutoff, row, sp.pfirst,
               sp.pend, ncand, cand_v, cand_l);
  }
}

// Producer warp pw of P: the posterior rows of diagonals pw, pw + P, ...
// A lane has UNROLL lanes' rows in flight: 16 (all of a row up to Lp =
// 512, one round trip a diagonal) in the dense mode, 8 in the top-k mode,
// whose candidate list would otherwise spill, and in a cluster's three
// models (a block's row is short, and its DP warps need the registers).
template <int NM, bool TOPK, bool CL>
__device__ void produce(const Args& a, const Span& sp, int pw, int P, int R,
                        int rowf, float* ring, uint64_t* full,
                        uint64_t* empty, float* cand_v, int* cand_l) {
  const int l = threadIdx.x & 31;
  const int Lp = a.Lp, B = a.B, W = Lp + 1, D = 2 * Lp + 1;
  const int b = sp.b;
  constexpr int UNROLL = TOPK || (CL && NM == 3) ? 8 : 16;
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
    // lane 0 is outside the grid
    if (!TOPK && l == 0 && sp.rank == 0) out[0] = 0.f;
    float* row = ring + (size_t)s * rowf + 4 - sp.lo;  // lane j at row[j]
    int ncand = 0;
    // the block's lanes, 32 * UNROLL at a time (j0 is the same in the warp)
    const int jend = sp.pend;
    for (int j0 = sp.pfirst; j0 < jend; j0 += 32 * UNROLL) {
      float fv[UNROLL][NM], rv[UNROLL][NM];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 32 * u + l;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          fv[u][m] = j < jend ? frow[m][j] : 0.f;
          rv[u][m] = has_rev && j < jend ? rrow[m][-j] : 0.f;
        }
      }
      // the DP has read the row this one overwrites
      if (j0 == sp.pfirst && use > 0) mbar_wait(empty + s, (use - 1) & 1);
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
        if (j < jend) {
          row[j] = post;
          if constexpr (!TOPK) out[j] = post;
        }
        if constexpr (TOPK)
          push_candidate(j < jend && post >= a.cutoff && post > 0.f, post, j,
                         ncand, cand_v, cand_l);
      }
    }
    if constexpr (TOPK) block_topk<CL>(a, sp, d, row, ncand, cand_v, cand_l);
    mbar_arrive(full + s);  // each lane after its own writes
  }
}

// Producer warp pw of P, GIVEN kind: the rows of diagonals pw, pw + P, ...
// of the plane in `fwd`, lanes 0 .. Lp, copied into the ring as they are;
// every lane, lane 0 too, a top-k candidate.
template <bool TOPK, bool CL>
__device__ void produce_given(const Args& a, const Span& sp, int pw, int P,
                              int R, int rowf, float* ring, uint64_t* full,
                              uint64_t* empty, float* cand_v, int* cand_l) {
  const int l = threadIdx.x & 31;
  const int Lp = a.Lp, B = a.B, W = Lp + 1, D = 2 * Lp + 1;
  const int b = sp.b;
  constexpr int UNROLL = 16;
  const int jend = sp.pend;
  for (int d = pw; d < D; d += P) {
    const int s = d % R, use = d / R;
    const float* src = a.fwd + ((size_t)d * B + b) * W;
    float* row = ring + (size_t)s * rowf + 4 - sp.lo;  // lane j at row[j]
    int ncand = 0;
    for (int j0 = sp.pfirst; j0 < jend; j0 += 32 * UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 32 * u + l;
        v[u] = j < jend ? src[j] : 0.f;
      }
      // the DP has read the row this one overwrites
      if (j0 == sp.pfirst && use > 0) mbar_wait(empty + s, (use - 1) & 1);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 32 * u + l;
        if (j < jend) row[j] = v[u];
        if constexpr (TOPK)
          push_candidate(j < jend && v[u] >= a.cutoff && v[u] > 0.f, v[u], j,
                         ncand, cand_v, cand_l);
      }
    }
    if constexpr (TOPK) block_topk<CL>(a, sp, d, row, ncand, cand_v, cand_l);
    mbar_arrive(full + s);  // each lane after its own writes
  }
}

// DP warp g of G: the MWT DP over the block's lanes sp.lo + 32 * LPT * g
// ... of every diagonal, in order, from the ring.  CL: the lane left of
// the block's first comes from the block to the left through this block's
// edge ring xv (xflag[0]: the diagonals delivered), and the block's last
// lane goes the same way to the block to the right (xflag[1]: the
// diagonals that block has read, as it last wrote back).
template <int LPT, bool WM, bool CL>
__device__ void mwt(const Args& a, const Span& sp, int g, int G, int R,
                    int rowf, const float* ring, uint64_t* full,
                    uint64_t* empty, float2* edge, float2* xv,
                    unsigned* xflag) {
  const int l = threadIdx.x & 31;
  const int Lp = a.Lp, W = Lp + 1, D = 2 * Lp + 1;
  const int b = sp.b;
  const int ly = a.ly[b], dterm = a.lx[b] + ly;
  const int t = g * 32 + l;             // the block's DP thread
  const int j0 = sp.lo + t * LPT;       // this thread's lanes
  const bool recv = CL && sp.rank > 0 && t == 0;
  const bool send = CL && sp.rank + 1 < sp.C && t == G * 32 - 1;
  unsigned seen = 0;  // (send) the right block's diagonals read, last seen
  float s1[LPT], s2[LPT], n1[LPT], n2[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) s1[k] = s2[k] = n1[k] = n2[k] = 0.f;
  float l2 = 0.f, nl2 = 0.f;  // s, n of (d-2, j0-1)
  float sc = 0.f, nbv = 0.f;
  int s = 0;
  unsigned ph = 0;  // ring row of diagonal d and its barrier phase parity
  for (int d = 0; d < D; ++d) {
    const int par = d & 1;
    // (d-1, j0-1): from the thread to the left, or across a warp edge, or
    // (CL) from the block to the left
    float l1 = __shfl_up_sync(FULL_MASK, s1[LPT - 1], 1);
    float nl1 = 0.f;
    if constexpr (WM) nl1 = __shfl_up_sync(FULL_MASK, n1[LPT - 1], 1);
    if (l == 0) {
      float2 e = g == 0 ? make_float2(0.f, 0.f)
                        : edge[(par ^ 1) * MAX_DP_WARPS + g];
      if constexpr (CL) {
        if (recv && d > 0) {
          while (ld_acquire_cluster(xflag) < (unsigned)d) {
          }
          e = xv[(d - 1) & (XE - 1)];
          if ((d & (XE / 2 - 1)) == 0)
            st_release_cluster(at_rank(xflag + 1, sp.rank - 1), (unsigned)d);
        }
      }
      l1 = e.x;
      nl1 = e.y;
    }
    float pv[LPT];
    mbar_wait(full + s, ph);
    const float* row = ring + (size_t)s * rowf + 4 - sp.lo + j0;  // 16 B
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
    if constexpr (CL) {
      if (send) {
        // the slot of diagonal d last held d - XE: wait until it was read
        while (seen + XE <= (unsigned)d) seen = ld_acquire_cluster(xflag + 1);
        *at_rank(xv + (d & (XE - 1)), sp.rank + 1) =
            make_float2(sn[LPT - 1], nn[LPT - 1]);
        st_release_cluster(at_rank(xflag, sp.rank + 1), (unsigned)d + 1);
      }
    }
    if (G > 1) {
      if (l == 31 && g + 1 < G)
        edge[par * MAX_DP_WARPS + g + 1] =
            make_float2(sn[LPT - 1], nn[LPT - 1]);
      dp_sync(32 * G);
    }
  }
  const int owner = ly >= 1 ? (ly - 1) / LPT : 0;  // thread of lane ly
  if (sp.rank * G * 32 + t == owner) {
    a.score[b] = sc;
    if (WM) a.nb[b] = nbv;
  }
}

// The cluster's top-k, after its last diagonal: warp gw of nw takes the
// diagonals gw, gw + nw, ... and ranks the C blocks' lists of each by the
// top-k order.  Up to 32 entries in all, one lane an entry (as
// write_topk); more, a merge of the lists' heads, lane r holding list r's
// best entry not taken yet.
__device__ void merge_topk(const Args& a, const Span& sp, int gw, int nw) {
  const int l = threadIdx.x & 31;
  const int D = 2 * a.Lp + 1, C = sp.C, kl = a.kl, k = a.topk;
  for (int d = gw; d < D; d += nw) {
    const size_t base = ((size_t)d * a.B + sp.b) * C;  // block 0's list
    float* vrow = a.vals + ((size_t)d * a.B + sp.b) * k;
    int32_t* lrow = a.lanes + ((size_t)d * a.B + sp.b) * k;
    const int n = l < C ? __ldcg(a.tkn + base + l) : 0;
    int inc = n;  // entries in lists 0 .. l
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, inc, o);
      if (l >= o) inc += v;
    }
    const int N = __shfl_sync(FULL_MASK, inc, 31);
    if (N <= 32) {
      // lane l takes entry l: list r, where lists 0 .. r-1 hold `start`
      int r = 0, start = 0;
      for (int q = 0; q < C; ++q) {
        const int e = __shfl_sync(FULL_MASK, inc, q);
        if (l >= e) {
          r = q + 1;
          start = e;
        }
      }
      float v = 0.f;
      int jl = 0;
      if (l < N) {
        const size_t at = (base + r) * kl + (l - start);
        v = __ldcg(a.tkv + at);
        jl = __ldcg(a.tkl + at);
      }
      int rank = 0;
      for (int i = 0; i < N; ++i) {
        const float v2 = __shfl_sync(FULL_MASK, v, i);
        const int j2 = __shfl_sync(FULL_MASK, jl, i);
        rank += (v2 > v || (v2 == v && j2 < jl)) ? 1 : 0;
      }
      if (l < N && rank < k) {
        vrow[rank] = v;
        lrow[rank] = jl;
      }
      for (int q = N + l; q < k; q += 32) {
        vrow[q] = 0.f;
        lrow[q] = 0;
      }
    } else {
      int pos = 0;
      float hv = -1.f;  // list l's head (-1: none left; entries are > 0)
      int hl = 0x7fffffff;
      auto head = [&]() {
        hv = -1.f;
        hl = 0x7fffffff;
        if (l < C && pos < n) {
          const size_t at = (base + l) * kl + pos;
          hv = __ldcg(a.tkv + at);
          hl = __ldcg(a.tkl + at);
        }
      };
      head();
      int t = 0;
      for (; t < k; ++t) {
        float bv = hv;
        int bl = hl, br = l;
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
          const int ol = __shfl_xor_sync(FULL_MASK, bl, o);
          const int orr = __shfl_xor_sync(FULL_MASK, br, o);
          if (ov > bv || (ov == bv && ol < bl)) {
            bv = ov;
            bl = ol;
            br = orr;
          }
        }
        if (!(bv > 0.f)) break;
        if (l == 0) {
          vrow[t] = bv;
          lrow[t] = bl;
        }
        if (l == br) {
          ++pos;
          head();
        }
      }
      for (int q = t + l; q < k; q += 32) {
        vrow[q] = 0.f;
        lrow[q] = 0;
      }
    }
  }
}

// threads a block at most: 384 for a cluster's 16 lanes a thread, which
// need 168 registers
__host__ __device__ constexpr int max_threads(int lpt, bool cl) {
  return cl && lpt == 16 ? 384 : 512;
}

// warps 0 .. G-1 run the DP, the rest produce posterior rows (NM = 0:
// the rows of a given plane); CL: block blockIdx.x % C of pair
// blockIdx.x / C in a cluster of C blocks
template <int NM, int LPT, bool TOPK, bool WM, bool CL>
__device__ __forceinline__ void combine_block(const Args& a, int G, int R,
                                              int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rowf = ring_row(G, LPT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)R * rowf);
  uint64_t* empty = full + R;
  float2* edge = reinterpret_cast<float2*>(empty + R);
  float* cand_v = reinterpret_cast<float*>(edge + 2 * MAX_DP_WARPS);
  int* cand_l = reinterpret_cast<int*>(cand_v + MAX_PRODUCERS * 32);
  float2* xv = reinterpret_cast<float2*>(cand_l + MAX_PRODUCERS * 32);
  unsigned* xflag = reinterpret_cast<unsigned*>(xv + XE);
  const int warp = threadIdx.x >> 5;
  const int nwarps = (int)(blockDim.x >> 5);
  const int P = nwarps - G;
  const int span = G * 32 * LPT;
  Span sp;
  sp.C = CL ? C : 1;
  sp.rank = CL ? (int)blockIdx.x % C : 0;
  sp.b = CL ? (int)blockIdx.x / C : (int)blockIdx.x;
  sp.lo = 1 + sp.rank * span;
  sp.pfirst = (NM == 0 && sp.rank == 0) ? 0 : sp.lo;
  sp.pend = CL ? min(a.Lp + 1, sp.lo + span) : a.Lp + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 32 * G);
    }
    if (CL) xflag[0] = xflag[1] = 0u;
    mbar_fence_init();
  }
  if (threadIdx.x < 2 * MAX_DP_WARPS)
    edge[threadIdx.x] = make_float2(0.f, 0.f);
  // (CL: every block's counts are set before any block writes them)
  if constexpr (CL)
    cg::this_cluster().sync();
  else
    __syncthreads();
  if (warp < G) {
    mwt<LPT, WM, CL>(a, sp, warp, G, R, rowf, smem, full, empty, edge, xv,
                     xflag);
  } else {
    const int pw = warp - G;
    if constexpr (NM == 0)
      produce_given<TOPK, CL>(a, sp, pw, P, R, rowf, smem, full, empty,
                              cand_v + pw * 32, cand_l + pw * 32);
    else
      produce<NM, TOPK, CL>(a, sp, pw, P, R, rowf, smem, full, empty,
                            cand_v + pw * 32, cand_l + pw * 32);
  }
  if constexpr (CL) {
    // every block's lists are written, and no block writes into another
    // after this
    cg::this_cluster().sync();
    if constexpr (TOPK) merge_topk(a, sp, sp.rank * nwarps + warp, C * nwarps);
  }
}

// one block a pair
template <int NM, int LPT, bool TOPK, bool WM>
__global__ void __launch_bounds__(512)
    combine_kernel(const Args a, int G, int R, int C) {
  combine_block<NM, LPT, TOPK, WM, false>(a, G, R, C);
}

// a cluster a pair: one block an SM, so a thread may take 65,536 / the
// block's threads registers
template <int NM, int LPT, bool TOPK, bool WM>
__global__ void __launch_bounds__(max_threads(LPT, true), 1)
    combine_cluster_kernel(const Args a, int G, int R, int C) {
  combine_block<NM, LPT, TOPK, WM, true>(a, G, R, C);
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The wrapper's plan: G DP warps and P producers a block, R ring rows, C
// blocks a pair (CL), `smem_plan` shared bytes, which must be this
// layout's; the blocks' lanes must cover the pair's.
template <int NM, int LPT, bool TOPK, bool WM, bool CL>
cudaError_t launch(const Args& a, int G, int P, int R, int C, int smem_plan,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(G, LPT, R, CL);
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (G < 1 || G > MAX_DP_WARPS || P < 1 || P > MAX_PRODUCERS || P > R ||
      32 * (G + P) > max_threads(LPT, CL) ||
      R > MAX_RING || C < 1 || C > (CL ? MAX_CLUSTER : 1) ||
      (long)C * G * 32 * LPT < a.Lp || smem != (size_t)smem_plan ||
      smem > (size_t)std::min(optin, MAX_SMEM))
    return cudaErrorInvalidValue;
  if (CL && TOPK &&
      (a.kl < 1 || a.kl > a.topk || !a.tkv || !a.tkl || !a.tkn))
    return cudaErrorInvalidValue;
  void (*kern)(const Args, int, int, int);
  if constexpr (CL)
    kern = combine_cluster_kernel<NM, LPT, TOPK, WM>;
  else
    kern = combine_kernel<NM, LPT, TOPK, WM>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (CL && C > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * C);
  cfg.blockDim = dim3(32 * (G + P));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL ? 1 : 0;
  if (CL) {
    // a cluster the card cannot place would never start
    int nclusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&nclusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (nclusters < 1) return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a, G, R, C);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NM, int LPT, bool CL>
cudaError_t launch_mode(const Args& a, bool with_matches, int G, int P,
                        int R, int C, int smem, cudaStream_t st) {
  if (a.topk > 0)
    return with_matches
               ? launch<NM, LPT, true, true, CL>(a, G, P, R, C, smem, st)
               : launch<NM, LPT, true, false, CL>(a, G, P, R, C, smem, st);
  return with_matches
             ? launch<NM, LPT, false, true, CL>(a, G, P, R, C, smem, st)
             : launch<NM, LPT, false, false, CL>(a, G, P, R, C, smem, st);
}

// inst 0: one block a pair, 16 lanes a thread; inst 1: a cluster a pair,
// 4, 8 or 16 lanes a thread
template <int NM>
cudaError_t launch_plan(const Args& a, bool wm, int inst, int lpt, int G,
                        int P, int R, int C, int smem, cudaStream_t st) {
  if (inst == 0 && lpt == 16)
    return launch_mode<NM, 16, false>(a, wm, G, P, R, C, smem, st);
  if (inst == 1 && lpt == 4)
    return launch_mode<NM, 4, true>(a, wm, G, P, R, C, smem, st);
  if (inst == 1 && lpt == 8)
    return launch_mode<NM, 8, true>(a, wm, G, P, R, C, smem, st);
  if (inst == 1 && lpt == 16)
    return launch_mode<NM, 16, true>(a, wm, G, P, R, C, smem, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// plan: {instance, lanes a thread, DP warps, producers, ring rows, blocks
// a pair, shared bytes, top-k list length}, from the wrapper's
// `combine_plan`; tkv / tkl / tkn: the cluster's top-k lists
extern "C" int combine_launch(const void* fwd, const void* fsc,
                              const void* fl2t, const void* rev,
                              const void* rsc, const void* rl2t,
                              const void* lx, const void* ly, int nm, int k0,
                              int k1, int k2, int B, int Lp,
                              int with_matches, int topk, float cutoff,
                              void* post, void* vals, void* lanes,
                              void* score, void* nb, int inst, int lpt,
                              int G, int P, int R, int C, int smem, int kl,
                              void* tkv, void* tkl, void* tkn,
                              void* stream) {
  const int W = Lp + 1;
  if (Lp < 0 || nm < 1 || nm > 3 || B < 1 || topk < 0 || topk > W)
    return (int)cudaErrorInvalidValue;
  // GIVEN: the only model, its plane in fwd
  const bool given = k0 == GIVEN;
  if ((given && nm != 1) || k1 == GIVEN || k2 == GIVEN)
    return (int)cudaErrorInvalidValue;
  const Args a = {(const float*)fwd, (const float*)fsc, (const float*)fl2t,
                  (const float*)rev, (const float*)rsc, (const float*)rl2t,
                  (const int32_t*)lx, (const int32_t*)ly, k0, k1, k2, B, Lp,
                  topk, cutoff, (float*)post, (float*)vals, (int32_t*)lanes,
                  (float*)score, (float*)nb, kl, (float*)tkv,
                  (int32_t*)tkl, (int32_t*)tkn};
  const auto st = (cudaStream_t)stream;
  const bool wm = with_matches != 0;
  cudaError_t err =
      given     ? launch_plan<0>(a, wm, inst, lpt, G, P, R, C, smem, st)
      : nm == 1 ? launch_plan<1>(a, wm, inst, lpt, G, P, R, C, smem, st)
      : nm == 2 ? launch_plan<2>(a, wm, inst, lpt, G, P, R, C, smem, st)
                : launch_plan<3>(a, wm, inst, lpt, G, P, R, C, smem, st);
  return (int)err;
}
