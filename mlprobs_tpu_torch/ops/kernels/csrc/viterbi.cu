// All-pairs local Viterbi of the feature pass, and its traceback
// statistics.
//
// Replaces no Pallas kernel: the JAX package runs this as two XLA scans,
// `viterbi_wavefront` (mlprobs_tpu/ops/wavefront.py:578, its `lax.scan`
// at :665) and `viterbi_path_stats` (:681, `lax.scan` at :742), jitted
// together in mlprobs_tpu/align/pairwise.py:1117 `viterbi_stat_batches`.
// Same contract as the plain PyTorch versions of those two functions
// (ops/wavefront.py): the (D, B, W) int8 direction plane, the end state
// and score of each pair, then each pair's path length, match count and
// per-step BLOSUM scores, last step first, (2*Lp, B).  D = 2*Lp + 1 rows,
// W = Lp + 1 lanes; row d, lane j is grid cell (d - j, j).
//
// What bounds it on the H100.  The bytes are the int8 direction plane,
// D*B*W bytes (134 MB at Lp = 512, B = 256: 0.04 ms at 3.35 TB/s), and
// 14 f32 adds and maxes a cell.  Neither is the limit: each diagonal
// needs the two before it, so a pair is a chain of 2*Lp + 1 steps, and
// at the main shape (two pairs an SM) the time is that chain's latency:
// a warp's diagonal (its shuffles, four cells of ~25 instructions, the
// direction stores, the hand-off to the next warp) takes several hundred
// cycles, not the ~100 its issue slots need (PERF.md).  The traceback is
// a chain of up to 2*Lp dependent reads of the plane, one pair at a time.
//
// Layout.  One block a pair.  A thread owns LANES contiguous lanes from
// lane 1 on and keeps their M, X and Y of diagonals d-1 and d-2 in
// registers (two sets, swapped every diagonal, with the emission scores
// of the next diagonal loaded while this one computes); the first
// warp's threads all compute lane 0 as well, whose lane j-1 is the zero
// fill, and its first thread keeps it.  A warp owns a strip of
// 32*LANES lanes.  Lane j-1 of a thread's first lane comes from the
// thread before it by a shuffle; the first thread of a strip gets it
// from the strip before through a ring of RING slots in shared memory,
// with a head and a tail counter that only the two warps read and write
// (release and acquire at block scope, PUB items a release, each
// released before the diagonal's plane stores so that its fence waits
// only for older ones): no barrier of the whole block in the loop over
// diagonals, and a warp runs up to RING diagonals ahead of the next.  A
// block has at most MAX_WARPS warps; a pair with more strips runs them
// in rounds (warp w takes strips w, w + nwb, ...), and a round's last
// strip hands its lane to the next round's first through a column of
// D - 1 items a pair in global scratch (two, by the round's parity), so
// the states never leave the SM at any length (up to MAX_LP).  Each
// thread stores its own direction bytes: a word as one 4-byte store, two
// 2-byte ones or byte, 2 bytes, byte, as the row's offset falls (rows
// start at any byte), evict-first so that the plane does not push the
// block's other data out of the L2 cache.
//
// The walk.  After one barrier, warp 0 walks the pair's path exactly as
// the plain version does, all 32 lanes in step.  It reads the plane a
// window at a time: 32 x 32 cells of the unskewed grid (rows r, lanes c)
// in shared memory, one byte a lane and row, loaded together when the
// path leaves the window.  A step lowers r or c or both by one, so a
// window serves at least 32 steps.  An index below zero wraps as a torch
// index does (row r + c + D, lane c + W), so cells outside the pair's
// rectangle give the plain version's bits too; a cell that torch could
// not index reads 0.  The steps past the path's end get the plain
// version's zeros.
//
// Arithmetic.  Max-plus in f32: adds, maxes and compares only, in the
// plain version's order and with its tie-breaks, so every output equals
// the plain version's bit for bit.  The (., j-1) dependency at lane 0 is
// the plain version's zero fill (F.pad), not LOG_ZERO; lanes past W - 1
// are computed on PAD classes and never stored or read by a real lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 20;
constexpr float LOG_ZERO = -1e30f;
constexpr int LANES = 4;       // lanes a thread
constexpr int MAX_WARPS = 16;  // warps a block
constexpr int RING = 64;       // slots of a strip-to-strip ring
constexpr int PUB = 16;        // items a counter's release publishes
constexpr int WIN = 32;        // the walk's window: WIN x WIN cells
constexpr int MAX_LP = 65536;
constexpr unsigned FULL = 0xffffffffu;

// the table block, in floats (mirrors ops/kernels/viterbi_kernel.py)
constexpr int T_LM = 0;        // lm[21][21], PAD row and column LOG_ZERO
constexpr int T_LINS = 441;    // lins[21], PAD LOG_ZERO
constexpr int T_TRANS = 462;   // trans[3][3], row = from-state
constexpr int T_VINIT = 471;   // vinit[3]
constexpr int T_BLOSUM = 474;  // blosum[21][21]
constexpr int T_SIZE = 915;
constexpr int T_FLOATS = 916;  // padded to 16 bytes

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

struct Layout {
  size_t tab, xo, x, y, ring, head, tail, win, term, total;
};

// the emission table first, at shared offset 0, so that a byte offset into
// it is a shared address: row xc holds lm[xc][0..20] and lins[xc]
constexpr int T2_ROW = 22;  // floats a row
__host__ __device__ inline Layout layout(int Lp) {
  Layout L;
  L.tab = round16(21 * T2_ROW * sizeof(float));
  L.xo = L.tab + T_FLOATS * sizeof(float);  // x_i's row offset, PAD at [Lp]
  L.x = L.xo + round16(2 * (Lp + 1));       // x classes, PAD at [Lp]
  L.y = L.x + round16(Lp + 1);
  L.ring = L.y + round16(Lp);
  L.head = L.ring + MAX_WARPS * RING * sizeof(float4);
  L.tail = L.head + MAX_WARPS * sizeof(int);
  L.win = L.tail + MAX_WARPS * sizeof(int);
  L.term = L.win + WIN * WIN;
  L.total = L.term + 4 * sizeof(float);
  return L;
}

// nt threads own lanes 1 .. nt*LANES (thread 0 also lane 0), ns strips
// of 32 threads, nwb warps a block (the strips split evenly over the
// fewest rounds)
struct Plan {
  int nt, ns, nwb;
};

__host__ __device__ inline Plan plan(int Lp) {
  Plan P;
  P.nt = (Lp + LANES - 1) / LANES;
  P.ns = (P.nt + 31) / 32;
  const int rounds = (P.ns + MAX_WARPS - 1) / MAX_WARPS;
  P.nwb = (P.ns + rounds - 1) / rounds;
  return P;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_cs_u32(int8_t* p, uint32_t v) {
  asm volatile("st.global.cs.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_cs_u16(int8_t* p, uint32_t v) {
  asm volatile("st.global.cs.b16 [%0], %1;" ::"l"(p), "h"((uint16_t)v)
               : "memory");
}

__device__ __forceinline__ void st_cs_u8(int8_t* p, uint32_t v) {
  asm volatile("st.global.cs.b8 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_cg_u8(const int8_t* p) {
  uint32_t v;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// M, X and Y of a thread's K lanes on one diagonal
template <int K>
struct Diag {
  float m[K], x[K], y[K];
};

// em and lins[x_i] of a thread's K lanes on one diagonal
template <int K>
struct Emit {
  float em[K], lix[K];
};

// The K direction bytes of a thread's lanes, from p on: the lanes below
// W (nvalid of them, at most K), each byte once.  The row's alignment
// changes from diagonal to diagonal; a full word goes as one aligned
// 4-byte store, or as two 2-byte ones, or as a byte, two bytes and a
// byte, by the address's offset (the same for every thread of a warp
// when 4 divides K).
template <int K>
__device__ __forceinline__ void store_own(int8_t* p, const uint32_t* bits,
                                          int nvalid) {
  if constexpr (K % 4 == 0) {
    const int o = (int)(reinterpret_cast<uintptr_t>(p) & 3);
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const uint32_t w = bits[4 * i] | bits[4 * i + 1] << 8 |
                         bits[4 * i + 2] << 16 | bits[4 * i + 3] << 24;
      int8_t* q = p + 4 * i;
      if (nvalid >= K) {
        if (o == 0) {
          st_cs_u32(q, w);
        } else if (o == 2) {
          st_cs_u16(q, w);
          st_cs_u16(q + 2, w >> 16);
        } else {
          st_cs_u8(q, w);
          st_cs_u16(q + 1, w >> 8);
          st_cs_u8(q + 3, w >> 24);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * i + k < nvalid) st_cs_u8(q + k, w >> (8 * k));
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u)
      if (u < nvalid) st_cs_u8(p + u, bits[u]);
  }
}

// One cell: the plain version's recurrences and tie-breaks.  (m2l, x2l,
// y2l): lane j-1 on diagonal d-2; (m1l, y1l): lane j-1 on d-1; (m1, x1):
// lane j on d-1; em, lix, liy: the emission and insert scores.  Returns
// the direction bits.
__device__ __forceinline__ uint32_t cell(float m2l, float x2l, float y2l,
                                         float m1l, float y1l, float m1,
                                         float x1, float em, float lix,
                                         float liy, const float* t, float& m,
                                         float& x, float& y) {
  const float cm = m2l + t[0];
  const float cx = x2l + t[1];
  const float cy = y2l + t[2];
  const float mx = fmaxf(fmaxf(cm, cx), cy);
  m = em + mx;
  // (cm >= cx && cm >= cy) ? 0 : (cx >= cy ? 1 : 2), as equalities with
  // the maximum (no NaN reaches a cell)
  const uint32_t tb_m = cm == mx ? 0u : (cx == mx ? 1u : 2u);
  const float from_m = m1 + t[3];
  const float from_x = x1 + t[4];
  x = lix + fmaxf(from_m, from_x);
  const float ym = m1l + t[5];
  const float yy = y1l + t[6];
  y = liy + fmaxf(ym, yy);
  return tb_m + (from_m < from_x ? 4u : 0u) + (ym < yy ? 8u : 0u);
}

template <int K>
__global__ void __launch_bounds__(MAX_WARPS * 32)
viterbi_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Y,
               const int32_t* __restrict__ LX,
               const int32_t* __restrict__ LY,
               const float* __restrict__ tab, int B, int Lp,
               int8_t* dirs, int32_t* __restrict__ end_state,
               float* __restrict__ score, int32_t* __restrict__ pathlen,
               int32_t* __restrict__ matches,
               float* __restrict__ scores_rev, float4* __restrict__ column) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Lp);
  float* s_t2 = reinterpret_cast<float*>(smem);
  float* s_tab = reinterpret_cast<float*>(smem + L.tab);
  uint16_t* s_xo = reinterpret_cast<uint16_t*>(smem + L.xo);
  int8_t* s_x = reinterpret_cast<int8_t*>(smem + L.x);
  int8_t* s_y = reinterpret_cast<int8_t*>(smem + L.y);
  float4* s_ring = reinterpret_cast<float4*>(smem + L.ring);
  int* s_head = reinterpret_cast<int*>(smem + L.head);
  int* s_tail = reinterpret_cast<int*>(smem + L.tail);
  int8_t* s_win = reinterpret_cast<int8_t*>(smem + L.win);
  float* s_term = reinterpret_cast<float*>(smem + L.term);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwb = nthr >> 5;
  const int W = Lp + 1, D = 2 * Lp + 1;
  const Plan P = plan(Lp);
  // the column from a round's last strip to the next round's first: two
  // buffers of D - 1 items a pair, by the parity of the producing round
  float4* col = column + (size_t)b * 2 * (D - 1);

  for (int k = tid; k < T_SIZE; k += nthr) s_tab[k] = tab[k];
  for (int k = tid; k < 21 * T2_ROW; k += nthr) {
    const int xc = k / T2_ROW, c = k % T2_ROW;
    s_t2[k] = c < 21 ? tab[T_LM + xc * 21 + c] : tab[T_LINS + xc];
  }
  for (int k = tid; k < Lp; k += nthr) {
    const int xc = X[(size_t)b * Lp + k];
    s_x[k] = (int8_t)xc;
    s_xo[k] = (uint16_t)(xc * T2_ROW * sizeof(float));
    s_y[k] = Y[(size_t)b * Lp + k];
  }
  if (tid == 0) {
    s_x[Lp] = PAD;
    s_xo[Lp] = PAD * T2_ROW * sizeof(float);
  }
  if (tid < MAX_WARPS) s_head[tid] = s_tail[tid] = 0;
  if (tid < 3) s_term[tid] = 0.0f;
  // lengths past Lp (which the plain version cannot index) are clamped,
  // so that no read leaves the pair's rows
  const int lx = min(max(LX[b], 0), Lp), ly = min(max(LY[b], 0), Lp);
  const int dterm = lx + ly;
  __syncthreads();

  // t00 t10 t20 (into M), t01 t11 (into X), t02 t22 (into Y)
  const float tr[7] = {s_tab[T_TRANS + 0], s_tab[T_TRANS + 3],
                       s_tab[T_TRANS + 6], s_tab[T_TRANS + 1],
                       s_tab[T_TRANS + 4], s_tab[T_TRANS + 2],
                       s_tab[T_TRANS + 8]};
  const float lins_pad = s_tab[T_LINS + PAD];
  const int up_ring = warp, down_ring = warp + 1 == nwb ? 0 : warp + 1;
  int prod_seq = 0, cons_seq = 0, known_head = 0, known_tail = 0;

  for (int s = warp; s < P.ns; s += nwb) {
    const int S0 = 1 + s * 32 * K;  // the strip's first lane
    const int j0 = S0 + lane * K;
    const int nvalid = W - j0;      // this thread's lanes below W
    const bool up = s > 0, down = s + 1 < P.ns;
    const int parity = (s / nwb) & 1;  // of this strip's round
    int ycol[K], xo[K];
    float liy[K];
    Diag<K> A, Bd;  // diagonals d-2 (then d) and d-1, swapped every diagonal
    Emit<K> EA, EB;  // em and lins[x] of diagonals d and d+1, swapped too
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int j = j0 + u;
      const int yc = j < W ? s_y[j - 1] : PAD;
      ycol[u] = yc * sizeof(float);
      liy[u] = s_tab[T_LINS + yc];
      xo[u] = PAD * T2_ROW * sizeof(float);  // diagonal 0: i <= 0
      A.m[u] = A.x[u] = A.y[u] = LOG_ZERO;
      Bd.m[u] = Bd.x[u] = Bd.y[u] = LOG_ZERO;
      EA.em[u] = *reinterpret_cast<const float*>(smem + xo[u] + ycol[u]);
      EA.lix[u] = reinterpret_cast<const float*>(smem + xo[u])[21];
    }
    // lane j0 - 1 on diagonals d-1 (n1) and d-2 (n2); lane 0 on d-1 (z)
    float n1m = LOG_ZERO, n1x = LOG_ZERO, n1y = LOG_ZERO;
    float zm = LOG_ZERO, zx = LOG_ZERO, zy = LOG_ZERO;
    // lane 0's emissions on diagonal 0 (x class PAD)
    float z_em = s_t2[T2_ROW * PAD + PAD], z_lix = s_t2[T2_ROW * PAD + 21];
    // row d of the plane at this thread's first lane
    int8_t* rowp = dirs + (size_t)b * W + j0;
    const size_t row_step = (size_t)B * W;

    auto diag = [&](Diag<K>& N, const Diag<K>& Pv, const Emit<K>& E,
                    Emit<K>& En, const int d) {
      // diagonal d+1's x classes (one lane up) and emissions, loaded while
      // this diagonal computes
#pragma unroll
      for (int u = K - 1; u > 0; --u) xo[u] = xo[u - 1];
      xo[0] = s_xo[min((unsigned)(d - j0), (unsigned)Lp)];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        En.em[u] = *reinterpret_cast<const float*>(smem + xo[u] + ycol[u]);
        En.lix[u] = reinterpret_cast<const float*>(smem + xo[u])[21];
      }
      const float n2m = n1m, n2x = n1x, n2y = n1y;
      float sm = __shfl_up_sync(FULL, Pv.m[K - 1], 1);
      float sx = __shfl_up_sync(FULL, Pv.x[K - 1], 1);
      float sy = __shfl_up_sync(FULL, Pv.y[K - 1], 1);
      if (up) {
        if (d >= 1) {  // the strip before's last lane, diagonal d-1
          while (known_head <= cons_seq)
            known_head = ld_acquire(s_head + up_ring);
          if (lane == 0) {
            const float4 v =
                warp == 0 ? col[(parity ^ 1) * (D - 1) + d - 1]
                          : s_ring[up_ring * RING + (cons_seq & (RING - 1))];
            sm = v.x;
            sx = v.y;
            sy = v.z;
          }
          ++cons_seq;
        } else if (lane == 0) {
          sm = sx = sy = LOG_ZERO;
        }
      } else {
        // strip 0: lane 0 itself, its lane j-1 the zero fill; every thread
        // of the warp computes it, thread 0 keeps it
        float m0, x0, y0;
        const uint32_t b0 = cell(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, zm, zx,
                                 z_em, z_lix, lins_pad, tr, m0, x0, y0);
        const unsigned char* row =  // lane 0's x class on diagonal d+1
            smem + s_xo[min((unsigned)d, (unsigned)Lp)];
        z_em = reinterpret_cast<const float*>(row)[PAD];
        z_lix = reinterpret_cast<const float*>(row)[21];
        if (d == 0) {
          m0 = s_tab[T_VINIT + 0];
          x0 = s_tab[T_VINIT + 1];
          y0 = s_tab[T_VINIT + 2];
        }
        if (lane == 0) {
          sm = zm;
          sx = zx;
          sy = zy;
          st_cs_u8(rowp - 1, b0);
          if (d == dterm && ly == 0) {
            s_term[0] = m0;
            s_term[1] = x0;
            s_term[2] = y0;
          }
        }
        zm = m0;
        zx = x0;
        zy = y0;
      }
      n1m = sm;
      n1x = sx;
      n1y = sy;

      uint32_t bits[K];
#pragma unroll
      for (int u = K - 1; u >= 0; --u)
        bits[u] = cell(u ? N.m[u - 1] : n2m, u ? N.x[u - 1] : n2x,
                       u ? N.y[u - 1] : n2y, u ? Pv.m[u - 1] : n1m,
                       u ? Pv.y[u - 1] : n1y, Pv.m[u], Pv.x[u], E.em[u],
                       E.lix[u], liy[u], tr, N.m[u], N.x[u], N.y[u]);
      if (d == dterm) {
#pragma unroll
        for (int u = 0; u < K; ++u)
          if (j0 + u == ly) {
            s_term[0] = N.m[u];
            s_term[1] = N.x[u];
            s_term[2] = N.y[u];
          }
      }

      // the counters' releases come before this diagonal's plane stores,
      // so that they wait only for older ones
      if (up && warp != 0 && lane == 0 && d >= 1 &&
          (cons_seq % PUB == 0 || d == D - 1))
        st_release(s_tail + up_ring, cons_seq);
      if (down && d < D - 1) {  // this strip's last lane, to the next
        const float4 v =
            make_float4(N.m[K - 1], N.x[K - 1], N.y[K - 1], 0.0f);
        const bool publish = (prod_seq + 1) % PUB == 0 || d == D - 2;
        if (warp + 1 < nwb) {
          while (prod_seq - known_tail >= RING)
            known_tail = ld_acquire(s_tail + down_ring);
          if (lane == 31) {
            s_ring[down_ring * RING + (prod_seq & (RING - 1))] = v;
            if (publish) st_release(s_head + down_ring, prod_seq + 1);
          }
        } else if (lane == 31) {  // to warp 0, next round: the column
          col[parity * (D - 1) + d] = v;
          if (publish) st_release(s_head, prod_seq + 1);
        }
        ++prod_seq;
      }
      store_own<K>(rowp, bits, nvalid);
      rowp += row_step;
    };

    for (int d = 0; d < D; d += 2) {
      diag(A, Bd, EA, EB, d);
      if (d + 1 < D) diag(Bd, A, EB, EA, d + 1);
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // The walk: the plain version's lockstep traceback, one pair
  const float f0 = s_term[0] + s_tab[T_VINIT + 0];
  const float f1 = s_term[1] + s_tab[T_VINIT + 1];
  const float f2 = s_term[2] + s_tab[T_VINIT + 2];
  const int es = (f0 >= f1 && f0 >= f2) ? 0 : (f1 >= f2 ? 1 : 2);
  if (lane == 0) {
    end_state[b] = es;
    score[b] = es == 0 ? f0 : (es == 1 ? f1 : f2);
  }
  const float* bl = s_tab + T_BLOSUM;
  int r = lx, c = ly, state = es, t = 0, nmatch = 0;
  // (r, c) in the window: row wr - rr, lane wc - WIN + 1 + cc, where
  // (wr, wc) was the path's cell when the window was loaded (rr = WIN:
  // the first step loads it)
  int rr = WIN, cc = 0;
  float* sp = scores_rev + b;  // step t's score
  for (; t < 2 * Lp && (r > 0 || c > 0); ++t, sp += B) {
    if (rr >= WIN || cc < 0) {
      __syncwarp();
      const int cl = c - WIN + 1 + lane;  // this lane's column
      const int pc = cl < 0 ? cl + W : cl;
      uint32_t v[WIN];
#pragma unroll
      for (int k = 0; k < WIN; ++k) {
        const int sk = r - k + cl;  // the plane's row
        const int pr = sk < 0 ? sk + D : sk;
        v[k] = (pr >= 0 && pr < D && pc >= 0 && pc < W)
                   ? ld_cg_u8(dirs + ((size_t)pr * B + b) * W + pc)
                   : 0u;
      }
#pragma unroll
      for (int k = 0; k < WIN; ++k) s_win[k * WIN + lane] = (int8_t)v[k];
      __syncwarp();
      rr = 0;
      cc = WIN - 1;
    }
    const int dbits = s_win[rr * WIN + cc];
    const int xc = s_x[r - 1 > 0 ? r - 1 : 0];
    const int yc = s_y[c - 1 > 0 ? c - 1 : 0];
    const float sc = bl[xc * 21 + yc];
    const bool is_b = state == 0;
    nmatch += (is_b & (xc == yc)) ? 1 : 0;
    if (lane == 0)
      *sp = (is_b & (xc < PAD) & (yc < PAD) & (sc < 10.0f)) ? sc : 0.0f;
    const int dr = state != 2, dc = state != 1;  // M: both; X: r; Y: c
    r -= dr;
    c -= dc;
    rr += dr;
    cc -= dc;
    state = state == 0 ? (dbits & 3)
            : state == 1 ? ((dbits >> 2) & 1)
                         : ((dbits >> 2) & 2);
  }
  for (int k = t + lane; k < 2 * Lp; k += 32)
    scores_rev[(size_t)k * B + b] = 0.0f;
  if (lane == 0) {
    pathlen[b] = t;
    matches[b] = nmatch;
  }
}

}  // namespace

// Floats of scratch a pair needs: 0 while a pair's strips fit in one
// round; past that (more than MAX_WARPS * 32 * LANES lanes) the caller
// passes B times this many, the column between rounds.
extern "C" int viterbi_scratch_floats(int Lp) {
  return plan(Lp).ns <= MAX_WARPS ? 0 : 2 * 2 * Lp * 4;
}

extern "C" int viterbi_launch(const void* X, const void* Y, const void* lx,
                              const void* ly, const void* tab, int B, int Lp,
                              void* dirs, void* end_state, void* score,
                              void* pathlen, void* matches, void* scores_rev,
                              void* scratch, void* stream) {
  if (Lp < 1 || Lp > MAX_LP || B < 1) return (int)cudaErrorInvalidValue;
  if (plan(Lp).ns > MAX_WARPS && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout(Lp).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_kernel<LANES><<<B, plan(Lp).nwb * 32, smem, (cudaStream_t)stream>>>(
      (const int8_t*)X, (const int8_t*)Y, (const int32_t*)lx,
      (const int32_t*)ly, (const float*)tab, B, Lp, (int8_t*)dirs,
      (int32_t*)end_state, (float*)score, (int32_t*)pathlen,
      (int32_t*)matches, (float*)scores_rev, (float4*)scratch);
  return (int)cudaGetLastError();
}
