// QuickProbs-exact HMM5 forward and backward ("qpx") of the realigner.
//
// Replaces no Pallas kernel: the JAX package runs this as two XLA scans
// in `hmm5_fb_qpx` (mlprobs_tpu/ops/qpx.py:157; the forward `lax.scan`
// at :252, the backward at :354), under jit in
// mlprobs_tpu/align/pairwise.py:524 `_qpx_combined_skew`.  Same contract
// as the plain PyTorch version (ops/qpx.py `hmm5_fb_qpx`): the forward and
// backward match planes in padded (D + 2, B, W + 1) buffers, LOG_ZERO in
// the padding, and each pair's forward and backward totals, which the
// wrapper averages as (totalF + totalB) * 0.5 in the same f32 operations.
// D = 2*Lp + 1 rows, W = Lp + 1 lanes; row d, lane j is grid cell
// (d - j, j).  The forward plane's diagonal d is buffer row d + 2 from
// lane 1; the backward's is buffer row d from lane 0.
//
// What bounds it on the H100.  Writing the two f32 planes (1.08 GB at
// Lp = 512, B = 256: 0.32 ms at 3.35 TB/s) and ~98 f32 operations a cell
// and direction (0.39 ms at 67 TFLOP/s, the larger).  Neither is reached:
// each diagonal needs the two before it, so a pair is a chain of 2*Lp + 1
// steps, one barrier each, and beside its f32 operations a cell issues
// more selects, guards and index arithmetic (cuobjdump -sass), so with
// every block's warps busy the SMs are issue-bound, not waiting on the
// chains.
//
// Layout.  One launch of 2B blocks: block 2b runs pair b's forward, block
// 2b + 1 its backward, at the same time (the two directions share
// nothing but the total, which the wrapper forms).  Each block loops over
// its diagonals, one barrier a diagonal.  The forward keeps the M state
// and the four insert states (x1, x2, y1, y2, a float4 a lane) of
// diagonals d, d-1 and d-2 in a ring of three slots; the backward keeps M
// of d, d+1 and d+2 and the inserts of d and d+1 (two slots: step d reads
// only d+1).  A diagonal reads its slots at lanes j and j-1 (forward) or
// j and j+1 (backward) and writes lane j of its own slot, so one barrier
// a diagonal orders every write after every read of the slot it reuses.
// Up to SMEM_LANES lanes the rings are in shared memory (60 bytes a lane
// forward, 44 backward); past that they are a per-pair slice of a scratch
// buffer that the wrapper allocates, which stays in the L2 cache.
//
// Only the lanes whose cells the plain version can reach are computed:
// the forward's lanes 0 .. min(d, Lp) (i >= 0; the cells past a pair's
// extent too, since the plain version computes them), the backward's
// lanes of its pair's grid, max(0, d - lx) .. min(d, ly).  Every other
// lane is LOG_ZERO: written so to the plane, and never written to the
// ring, where a read of it finds the LOG_ZERO fill (a lane leaves a
// direction's range only where no later diagonal reads it again).  A
// thread takes lanes tid, tid + blockDim.x, ...: only the warps that a
// diagonal's lanes need work, and the idle ones leave the SM's issue
// slots to the other blocks.  A cell reads everything first, then runs
// its chains, then stores, and every LOG_ADD is branch-free (a predicated
// select drops the cubic), so the match chain's four steps overlap the
// four independent insert LOG_ADDs.  One lane a thread (576 threads, two
// blocks an SM, at most 56 registers) timed faster on the H100 than 2 or
// 4 lanes a thread with their chains interleaved: more lanes a thread
// need more registers, so fewer warps hide the chains (PERF.md).
// LOOKUP_FLOAT's bounds are in registers and
// its four pieces' coefficients in shared memory, one float4 load a
// LOG_ADD: a register table's twelve selects a LOG_ADD cost more issue
// slots than the load's latency, and timed slower on the card.
//
// Arithmetic.  Every cell gets the plain version's f32 operations in its
// order, so both planes and the totals equal it bit for bit: LOOKUP_FLOAT
// with the piece picked by x <= 1, <= 2.5, <= 4.5, else (torch.bucketize)
// and each polynomial as separate multiplies and adds (built with
// --fmad=false, never fast-math); LOG_ADD with hi = max, lo = min, exact
// LOG_ZERO absorption and the 7.5 threshold; the guards on unreached
// states; the presets and the terminal captures.  The coefficients come
// in the table block from the same f32 tensors the plain version uses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 20;
constexpr int OFF = 21;  // the all-LOG_ZERO class past the last lane
constexpr int NCLS = 22;
constexpr int SMEM_LANES = 2048;
constexpr int MAX_LP = 65536;
constexpr float LOG_ZERO = -2e20f;
constexpr float HALF_LOG_ZERO = -1e20f;
constexpr float THR = 7.5f;

// the table block, in floats (mirrors ops/kernels/qpx_kernel.py)
constexpr int Q_LM = 0;      // lm[22][22], class 21 LOG_ZERO
constexpr int Q_LI = 484;    // li[2][22]: insert state 1 then 2
constexpr int Q_T = 528;     // trans[5][5], row = from-state
constexpr int Q_INIT = 553;  // init[5]
constexpr int Q_LB = 558;    // LOOKUP_FLOAT bounds[3]
constexpr int Q_LC = 561;    // LOOKUP_FLOAT coefficients[4][4]
constexpr int Q_SIZE = 577;
constexpr int Q_FLOATS = 580;  // padded to 16 bytes
constexpr int N_CAP = 12;
// ring floats a lane: forward the inserts' 3 slots of 4 states, M's 3
// slots; backward the inserts' 2 slots, M's 3
constexpr int FWD_RING = 15;
constexpr int BWD_RING = 11;

// threads a block at most, and the blocks an SM must hold (which caps the
// registers a thread)
constexpr int MAX_THREADS = 576;
constexpr int MIN_BLOCKS = 2;

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// a ring row's floats: the lanes rounded up to 4, so that every slot of
// the inserts starts on 16 bytes
__host__ __device__ inline int ring_row(int Lp) { return (Lp + 1 + 3) & ~3; }

struct Layout {
  size_t lut, li2, x, y, cap, ring, total;
};

__host__ __device__ inline Layout layout(int Lp, int ring_floats) {
  Layout L;
  L.lut = Q_FLOATS * sizeof(float);     // LOOKUP_FLOAT's pieces, float4s
  L.li2 = L.lut + 16 * sizeof(float);   // li by class, float2s
  L.x = L.li2 + round16(2 * NCLS * sizeof(float));
  L.y = L.x + round16(Lp);
  L.cap = L.y + round16(Lp);
  L.ring = L.cap + round16(N_CAP * sizeof(float));
  L.total = L.ring + (size_t)ring_floats * ring_row(Lp) * sizeof(float);
  return L;
}

// threads a block: a warp multiple that gives Lp + 1 lanes one a thread,
// at most MAX_THREADS
inline int block_threads(int Lp) {
  const int nt = (Lp + 1 + 31) / 32 * 32;
  return nt < MAX_THREADS ? nt : MAX_THREADS;
}

// LOOKUP_FLOAT's bounds, in registers, and its four pieces' coefficients,
// a float4 each in shared memory
struct Lookup {
  float b0, b1, b2;
  const float4* c;
};

// LOOKUP_FLOAT: piecewise-cubic log1p(exp(x)) on [0, 7.5]; the piece is
// k = x <= b0 ? 0 : x <= b1 ? 1 : x <= b2 ? 2 : 3, as torch.bucketize
__device__ __forceinline__ float lookup_float(float x, const Lookup& t) {
  const int k = (x > t.b0) + (x > t.b1) + (x > t.b2);
  const float4 c = t.c[k];
  return ((c.x * x + c.y) * x + c.z) * x + c.w;
}

// c ? a : b as one predicated select: written as a ternary around a
// cubic, the compiler branches around the cubic instead, and each branch
// ends a basic block, so the independent LOG_ADDs of a cell could no
// longer overlap
__device__ __forceinline__ float select(bool c, float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\nselp.f32 %0, %2, %3, p;\n}"
      : "=f"(r)
      : "r"((unsigned)c), "f"(a), "f"(b));
  return r;
#else
  return c ? a : b;
#endif
}

// LOG_ADD: exact LOG_ZERO absorption, the 7.5 underflow threshold; the
// cubic is evaluated for every pair, and dropped by the select
__device__ __forceinline__ float log_add(float x, float y, const Lookup& t) {
  const float hi = fmaxf(x, y);
  const float lo = fminf(x, y);
  const float d = hi - lo;
  return select(lo == LOG_ZERO || d >= THR, hi, lookup_float(d, t) + lo);
}

// p == LOG_ZERO ? LOG_ZERO : p + t, the guard on a term from an unreached
// state
__device__ __forceinline__ float guard(float p, float t) {
  return p == LOG_ZERO ? LOG_ZERO : p + t;
}

// the shared prologue: tables, both sequences, the captures, the ring
struct Block {
  const float* tab;
  const float2* li2;  // (li[0][c], li[1][c]) of class c
  const int8_t* x;
  const int8_t* y;
  float* cap;
  float* ring;
  Lookup lk;
  int lx, ly;
};

__device__ Block prologue(unsigned char* smem, const Layout& L,
                          float* ring, int ring_floats, int b,
                          const int8_t* X, const int8_t* Y,
                          const int32_t* LX, const int32_t* LY,
                          const float* tab, int Lp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* stab = reinterpret_cast<float*>(smem);
  float* lut = reinterpret_cast<float*>(smem + L.lut);
  float* li2 = reinterpret_cast<float*>(smem + L.li2);
  int8_t* x = reinterpret_cast<int8_t*>(smem + L.x);
  int8_t* y = reinterpret_cast<int8_t*>(smem + L.y);
  Block k;
  k.cap = reinterpret_cast<float*>(smem + L.cap);
  k.ring = ring;
  for (int i = tid; i < Q_SIZE; i += nt) stab[i] = tab[i];
  for (int i = tid; i < 16; i += nt) lut[i] = tab[Q_LC + i];
  for (int i = tid; i < 2 * NCLS; i += nt)
    li2[i] = tab[Q_LI + (i & 1) * NCLS + (i >> 1)];
  for (int i = tid; i < Lp; i += nt) {
    x[i] = X[(size_t)b * Lp + i];
    y[i] = Y[(size_t)b * Lp + i];
  }
  for (int i = tid; i < N_CAP; i += nt) k.cap[i] = LOG_ZERO;
  for (int i = tid; i < ring_floats * ring_row(Lp); i += nt)
    k.ring[i] = LOG_ZERO;
  k.tab = stab;
  k.li2 = reinterpret_cast<const float2*>(li2);
  k.x = x;
  k.y = y;
  k.lk = {tab[Q_LB], tab[Q_LB + 1], tab[Q_LB + 2],
          reinterpret_cast<const float4*>(lut)};
  // lengths past Lp (which the plain version cannot index) are clamped,
  // so that no read leaves the pair's rows
  k.lx = min(max(LX[b], 0), Lp);
  k.ly = min(max(LY[b], 0), Lp);
  return k;
}

// x class of grid row i as the plain version's clipped feed gives it:
// PAD for i <= 0, x_i, and x_Lp past the last row
__device__ __forceinline__ int x_class(const int8_t* x, int i, int Lp) {
  return i <= 0 ? PAD : (i <= Lp ? x[i - 1] : x[Lp - 1]);
}

__device__ __forceinline__ float4 lz4() {
  return make_float4(LOG_ZERO, LOG_ZERO, LOG_ZERO, LOG_ZERO);
}

// The forward's ring: the inserts' slot q (4 states of a lane, x1 x2 y1
// y2, as a float4) and M's slot q.
__device__ void forward(const Block& k, int b, int B, int Lp,
                        float* __restrict__ fwd_mp,
                        float* __restrict__ total_f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = Lp + 1, D = 2 * Lp + 1, WB = W + 1, R = ring_row(Lp);
  const int dterm = k.lx + k.ly;
  const Lookup& lk = k.lk;
  float4* ins_ring = reinterpret_cast<float4*>(k.ring);
  float* m_ring = k.ring + 12 * R;
  // buffer rows 0 and 1 (diagonals -2 and -1): the LOG_ZERO fill
  for (int i = tid; i < 2 * WB; i += nt)
    fwd_mp[((size_t)(i / WB) * B + b) * WB + i % WB] = LOG_ZERO;
  __syncthreads();
  const float* T = k.tab + Q_T;
  const float* i5 = k.tab + Q_INIT;
  const float* lm = k.tab + Q_LM;
  const float t00 = T[0];
  // per insert state x1, x2, y1, y2: into M, from M, self; init
  const float tk0[4] = {T[5], T[15], T[10], T[20]};
  const float t0q[4] = {T[1], T[3], T[2], T[4]};
  const float tqq[4] = {T[6], T[18], T[12], T[24]};
  const float i5q[4] = {i5[1], i5[3], i5[2], i5[4]};
  const float i50 = i5[0];

  for (int d = 0; d < D; ++d) {
    float* Mn = m_ring + (d % 3) * R;
    const float* M1 = m_ring + ((d + 2) % 3) * R;
    const float* M2 = m_ring + ((d + 1) % 3) * R;
    float4* In = ins_ring + (d % 3) * R;
    const float4* I1 = ins_ring + ((d + 2) % 3) * R;
    const float4* I2 = ins_ring + ((d + 1) % 3) * R;
    float* orow = fwd_mp + ((size_t)(d + 2) * B + b) * WB;
    const int n = min(d, Lp) + 1;  // lanes 0 .. n-1: i >= 0
    if (tid == 0) orow[0] = LOG_ZERO;
    for (int j = n + tid; j < W; j += nt) orow[j + 1] = LOG_ZERO;
    for (int j = tid; j < n; j += nt) {
      const int i = d - j;
      // Every read first (the slots of d-1 and d-2, which no store of
      // this diagonal touches, and the tables), then the chains, then
      // every store.
      // match: the five d-2 states at lane j-1; inserts: x from (i-1, j)
      // and y from (i, j-1), both at d-1
      const int xr = x_class(k.x, i, Lp);
      const int yg = j == 0 ? PAD : k.y[j - 1];
      const float em = lm[xr * NCLS + yg];
      const float m2 = j >= 1 ? M2[j - 1] : LOG_ZERO;
      const float4 i2 = j >= 1 ? I2[j - 1] : lz4();
      const float pmx = M1[j];
      const float pmy = j >= 1 ? M1[j - 1] : LOG_ZERO;
      const float2 i1x = reinterpret_cast<const float2*>(I1 + j)[0];
      const float2 i1y = j >= 1
                             ? reinterpret_cast<const float2*>(I1 + j - 1)[1]
                             : make_float2(LOG_ZERO, LOG_ZERO);
      const float2 lx = k.li2[xr], ly = k.li2[yg];
      const float p2[4] = {i2.x, i2.y, i2.z, i2.w};
      const float pm[4] = {pmx, pmx, pmy, pmy};
      const float ps[4] = {i1x.x, i1x.y, i1y.x, i1y.y};
      const float ins[4] = {lx.x, lx.y, ly.x, ly.y};
      // the match chain, inserts in the order x1, y1, x2, y2
      const float a0 = m2 + t00;
      float acc = a0 > HALF_LOG_ZERO ? a0 : LOG_ZERO;
      const int order[4] = {0, 2, 1, 3};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc = log_add(acc, guard(p2[order[q]], tk0[order[q]]), lk);
      // the inserts, independent of the chain
      float val[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bool is_x = s < 2;
        float v = ins[s] + log_add(guard(pm[s], t0q[s]),
                                   guard(ps[s], tqq[s]), lk);
        if (d == 1 && j == (is_x ? 0 : 1)) v = i5q[s] + ins[s];
        const bool mask = is_x ? (i >= 1) : (j >= 1 && i >= 0);
        val[s] = mask ? v : LOG_ZERO;
      }
      float m_new = acc + em;
      if (d == 2 && j == 1) m_new = i50 + em;  // init cell (1, 1)
      const float mv = (i >= 1 && j >= 1) ? m_new : LOG_ZERO;
      orow[j + 1] = mv;
      Mn[j] = mv;
      In[j] = make_float4(val[0], val[1], val[2], val[3]);
      if (d == dterm && j == k.ly) {
        k.cap[4] = mv;
#pragma unroll
        for (int s = 0; s < 4; ++s) k.cap[s] = val[s];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    // total at (lx, ly): order M, X1, Y1, X2, Y2
    const float picks[5] = {k.cap[4], k.cap[0], k.cap[2], k.cap[1],
                            k.cap[3]};
    float tf = LOG_ZERO;
    for (int q = 0; q < 5; ++q) {
      const float v = picks[q];
      tf = log_add(tf, v == 0.0f ? LOG_ZERO : v + i5[q], lk);
    }
    total_f[b] = tf;
  }
}

// The backward's ring: the inserts' slot q (float4s, as the forward's)
// and M's slot q.
__device__ void backward(const Block& k, int b, int B, int Lp,
                         float* __restrict__ bwd_mp,
                         float* __restrict__ total_b) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = Lp + 1, D = 2 * Lp + 1, WB = W + 1, R = ring_row(Lp);
  const int dterm = k.lx + k.ly;
  const Lookup& lk = k.lk;
  float4* ins_ring = reinterpret_cast<float4*>(k.ring);
  float* m_ring = k.ring + 8 * R;
  // buffer rows D and D + 1: the LOG_ZERO fill
  for (int i = tid; i < 2 * WB; i += nt)
    bwd_mp[((size_t)(D + i / WB) * B + b) * WB + i % WB] = LOG_ZERO;
  __syncthreads();
  const float* T = k.tab + Q_T;
  const float* i5 = k.tab + Q_INIT;
  const float* lm = k.tab + Q_LM;
  const float* li = k.tab + Q_LI;
  const float t00 = T[0];
  const float tb4[4] = {T[1], T[3], T[2], T[4]};
  const float te4[4] = {T[6], T[18], T[12], T[24]};
  const float pt4[4] = {T[5], T[15], T[10], T[20]};
  const float i5b[4] = {i5[1], i5[3], i5[2], i5[4]};
  const float i50 = i5[0];
  const float2 lz2 = make_float2(LOG_ZERO, LOG_ZERO);

  for (int d = D - 1; d >= 0; --d) {
    float* Mn = m_ring + (d % 3) * R;
    const float* M2 = m_ring + ((d + 2) % 3) * R;
    float4* In = ins_ring + (d % 2) * R;
    const float4* I1 = ins_ring + ((d + 1) % 2) * R;
    float* orow = bwd_mp + ((size_t)d * B + b) * WB;
    // the pair's grid on this diagonal: lanes lo .. hi (i <= lx, j <= ly)
    const int lo = max(0, d - k.lx), hi = min(d, k.ly);
    if (tid == 0) orow[W] = LOG_ZERO;
    for (int j = tid; j < W; j += nt)
      if (j < lo || j > hi) orow[j] = LOG_ZERO;
    if (lo > hi) continue;  // no cell of the grid: nothing on the ring
    for (int j = lo + tid; j <= hi; j += nt) {
      const int i = d - j;
      // next characters: x_{i+1} (diagonal d+1's x row), y_{j+1}
      const int xr1 = x_class(k.x, i + 1, Lp);
      const int yn = j < Lp ? k.y[j] : OFF;
      const float em_n = d <= D - 3 ? lm[xr1 * NCLS + yn] : LOG_ZERO;
      const float2 ixn = d <= D - 2 ? k.li2[xr1] : lz2;
      const float2 iyn = k.li2[yn];
      const bool mask_i = i < k.lx, mask_j = j < k.ly;
      // ProbXY = b[i+1, j+1] + matchProb(c1, c2): d+2, lane j+1
      const float n2m = j + 1 < W ? M2[j + 1] : LOG_ZERO;
      const float pxy = n2m == LOG_ZERO ? LOG_ZERO : n2m + em_n;
      const bool pxy_ok = mask_i && mask_j && pxy != LOG_ZERO;
      float acc = pxy_ok ? pxy + t00 : LOG_ZERO;
      // x states of (i+1, j) at d+1, lane j; y states of (i, j+1) at
      // d+1, lane j+1
      const float2 s4x = reinterpret_cast<const float2*>(I1 + j)[0];
      const float2 s4y = j + 1 < W
                             ? reinterpret_cast<const float2*>(I1 + j + 1)[1]
                             : lz2;
      const float s4[4] = {s4x.x, s4x.y, s4y.x, s4y.y};
      const float in4[4] = {ixn.x, ixn.y, iyn.x, iyn.y};
      float se[4];
      bool ok4[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        se[s] = s4[s] + in4[s];
        ok4[s] = (s < 2 ? mask_i : mask_j) && s4[s] != LOG_ZERO;
      }
      // order into b: M, X1, X2, Y1, Y2
#pragma unroll
      for (int s = 0; s < 4; ++s)
        acc = log_add(acc, ok4[s] ? se[s] + tb4[s] : LOG_ZERO, lk);
      // the insert levels, independent of the chain
      float val[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float lvl = pxy_ok ? pxy + pt4[s] : LOG_ZERO;
        val[s] = log_add(lvl, ok4[s] ? se[s] + te4[s] : LOG_ZERO, lk);
      }
      // the grid's cells only: every lane of the range is valid
      const bool term = d == dterm && j == k.ly;  // initial distribution
      const float bm = term ? i50 : acc;
      float v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = term ? i5b[s] : val[s];
      orow[j] = bm;
      Mn[j] = bm;
      In[j] = make_float4(v[0], v[1], v[2], v[3]);
      if (d == 2 && j == 1) k.cap[8] = bm;
      if (d == 1 && j <= 1) {
#pragma unroll
        for (int s = 0; s < 4; ++s) k.cap[4 * j + s] = v[s];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    // total = init0 + matchProb(x1, y1) + b[1,1]; then X1, Y1, X2, Y2
    // with the (1,0)/(0,1) insert levels of diagonal 1
    const int x1 = k.x[0], y1 = k.y[0];
    float tb = i5[0] + lm[x1 * NCLS + y1];
    tb = tb + k.cap[8];
    tb = log_add(tb, (i5[1] + li[x1]) + k.cap[0], lk);
    tb = log_add(tb, (i5[2] + li[y1]) + k.cap[4 + 2], lk);
    tb = log_add(tb, (i5[3] + li[NCLS + x1]) + k.cap[1], lk);
    tb = log_add(tb, (i5[4] + li[NCLS + y1]) + k.cap[4 + 3], lk);
    total_b[b] = tb;
  }
}

// block 2b: pair b's forward; block 2b + 1: its backward
template <bool SMEM_RING>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
qpx_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Y,
           const int32_t* __restrict__ LX, const int32_t* __restrict__ LY,
           const float* __restrict__ tab, int B, int Lp,
           float* __restrict__ fwd_mp, float* __restrict__ bwd_mp,
           float* __restrict__ total_f, float* __restrict__ total_b,
           float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x >> 1;
  const bool fwd = (blockIdx.x & 1) == 0;
  const int R = ring_row(Lp);
  const Layout L = layout(Lp, SMEM_RING ? FWD_RING : 0);
  float* ring = SMEM_RING
                    ? reinterpret_cast<float*>(smem + L.ring)
                    : scratch + (size_t)b * (FWD_RING + BWD_RING) * R +
                          (fwd ? 0 : (size_t)FWD_RING * R);
  const Block k = prologue(smem, L, ring, fwd ? FWD_RING : BWD_RING, b, X,
                           Y, LX, LY, tab, Lp);
  if (fwd)
    forward(k, b, B, Lp, fwd_mp, total_f);
  else
    backward(k, b, B, Lp, bwd_mp, total_b);
}

template <bool SMEM_RING>
cudaError_t launch(const int8_t* X, const int8_t* Y, const int32_t* LX,
                   const int32_t* LY, const float* tab, int B, int Lp,
                   float* fwd_mp, float* bwd_mp, float* total_f,
                   float* total_b, float* scratch, cudaStream_t stream) {
  const int nt = block_threads(Lp);
  const size_t sm = layout(Lp, SMEM_RING ? FWD_RING : 0).total;
  auto kern = qpx_kernel<SMEM_RING>;
  if (sm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return err;
  }
  kern<<<2 * B, nt, sm, stream>>>(X, Y, LX, LY, tab, B, Lp, fwd_mp, bwd_mp,
                                  total_f, total_b, scratch);
  return cudaGetLastError();
}

}  // namespace

// Floats of ring scratch a pair needs: 0 while the rings fit in shared
// memory; past SMEM_LANES lanes the caller passes B times this many (the
// forward's ring, then the backward's).
extern "C" int qpx_scratch_floats(int Lp) {
  return Lp + 1 <= SMEM_LANES ? 0 : (FWD_RING + BWD_RING) * ring_row(Lp);
}

extern "C" int qpx_launch(const void* X, const void* Y, const void* lx,
                          const void* ly, const void* tab, int B, int Lp,
                          void* fwd_mp, void* bwd_mp, void* total_f,
                          void* total_b, void* scratch, void* stream) {
  if (Lp < 1 || Lp > MAX_LP || B < 1) return (int)cudaErrorInvalidValue;
  const bool smem_ring = Lp + 1 <= SMEM_LANES;
  if (!smem_ring && scratch == nullptr) return (int)cudaErrorInvalidValue;
  auto* x = (const int8_t*)X;
  auto* y = (const int8_t*)Y;
  auto* a = (const int32_t*)lx;
  auto* c = (const int32_t*)ly;
  auto* t = (const float*)tab;
  auto* f = (float*)fwd_mp;
  auto* g = (float*)bwd_mp;
  auto* tf = (float*)total_f;
  auto* tb = (float*)total_b;
  auto* s = (float*)scratch;
  auto st = (cudaStream_t)stream;
  const cudaError_t err =
      smem_ring ? launch<true>(x, y, a, c, t, B, Lp, f, g, tf, tb, s, st)
                : launch<false>(x, y, a, c, t, B, Lp, f, g, tf, tb, s, st);
  return (int)err;
}
