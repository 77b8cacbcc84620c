// QuickProbs-exact HMM5 forward and backward ("qpx") of the realigner.
//
// Replaces no Pallas kernel: the JAX package runs this as two XLA scans
// in `hmm5_fb_qpx` (mlprobs_tpu/ops/qpx.py:157; the forward `lax.scan`
// at :252, the backward at :354), under jit in
// mlprobs_tpu/align/pairwise.py:524 `_qpx_combined_skew`.  Same contract
// as the plain PyTorch version (ops/qpx.py `hmm5_fb_qpx`): the forward and
// backward match planes in padded (D + 2, B, W + 1) buffers, LOG_ZERO in
// the padding, and the total (totalF + totalB) / 2 of each pair.  D =
// 2*Lp + 1 rows, W = Lp + 1 lanes; row d, lane j is grid cell (d - j, j).
// The forward plane's diagonal d is buffer row d + 2 from lane 1; the
// backward's is buffer row d from lane 0.
//
// What bounds it on the H100.  Writing the two f32 planes (1.08 GB at
// Lp = 512, B = 256: 0.32 ms at 3.35 TB/s) and ~98 f32 operations a cell
// and direction (0.39 ms at 67 TFLOP/s, the larger).  Neither is the limit:
// each diagonal needs the two before it, so a pair is a chain of 2*Lp + 1
// steps, each a few dependent LOG_ADDs (a compare, a subtract, a cubic
// picked by interval) and a barrier, and the latency of one step sets
// the time.
//
// Layout.  Two kernels, forward then backward, each with one block per
// pair and the loop over diagonals inside the block, one barrier a
// diagonal: the simplest design that keeps every dependency on chip.
// The forward keeps the M state and the four insert states (order x1,
// x2, y1, y2) of diagonals d, d-1 and d-2 in a ring of three slots; the
// backward keeps M of d, d+1 and d+2 and the inserts of d and d+1 (two
// slots suffice: step d reads only d+1).  A diagonal reads its slots at
// lanes j and j-1 (forward) or j and j+1 (backward) and writes lane j of
// its own slot, so one barrier a diagonal orders every write after every
// read of the slot it reuses.  A thread owns the lanes j = tid, tid +
// nt, ...; nt is half the lanes rounded up to a warp, at most 1,024.  Up
// to SMEM_LANES lanes the rings are in shared memory (60 bytes a lane
// forward, 44 backward); past that they are a per-pair slice of a scratch
// buffer that the wrapper allocates, which stays in the L2 cache.  The
// forward's total goes to a (B,) buffer that the backward reads, on the
// same stream; the backward writes the final total.
//
// Arithmetic.  Every cell gets the plain version's f32 operations in its
// order, so both planes and the total equal it bit for bit: LOOKUP_FLOAT
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
constexpr int MAX_THREADS = 1024;
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
constexpr int FWD_RING = 15;  // floats a lane: M x 3 slots, inserts 4 x 3
constexpr int BWD_RING = 11;  // M x 3 slots, inserts 4 x 2

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

struct Layout {
  size_t x, y, cap, ring, total;
};

__host__ __device__ inline Layout layout(int Lp, int ring_floats) {
  Layout L;
  L.x = Q_FLOATS * sizeof(float);
  L.y = L.x + round16(Lp);
  L.cap = L.y + round16(Lp);
  L.ring = L.cap + N_CAP * sizeof(float) + 16;
  L.total = L.ring + (size_t)ring_floats * (Lp + 1) * sizeof(float);
  return L;
}

inline int threads_for(int W) {
  const int half = (W + 1) / 2;
  const int nt = (half + 31) / 32 * 32;
  return nt < MAX_THREADS ? nt : MAX_THREADS;
}

// LOOKUP_FLOAT: piecewise-cubic log1p(exp(x)) on [0, 7.5]
__device__ __forceinline__ float lookup_float(float x, const float* tab) {
  const int k = x <= tab[Q_LB] ? 0
                : x <= tab[Q_LB + 1] ? 1
                : x <= tab[Q_LB + 2] ? 2 : 3;
  const float* c = tab + Q_LC + 4 * k;
  return ((c[0] * x + c[1]) * x + c[2]) * x + c[3];
}

// LOG_ADD: exact LOG_ZERO absorption, the 7.5 underflow threshold
__device__ __forceinline__ float log_add(float x, float y, const float* tab) {
  const float hi = fmaxf(x, y);
  const float lo = fminf(x, y);
  const float d = hi - lo;
  return (lo == LOG_ZERO || d >= THR) ? hi : lookup_float(d, tab) + lo;
}

// the shared prologue: tables, both sequences, the captures, the ring
struct Block {
  float* tab;
  int8_t* x;
  int8_t* y;
  float* cap;
  float* ring;
  int lx, ly;
};

__device__ Block prologue(unsigned char* smem, const Layout& L,
                          bool smem_ring, int ring_floats,
                          const int8_t* X, const int8_t* Y,
                          const int32_t* LX, const int32_t* LY,
                          const float* tab, int Lp, float* scratch) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int W = Lp + 1;
  Block k;
  k.tab = reinterpret_cast<float*>(smem);
  k.x = reinterpret_cast<int8_t*>(smem + L.x);
  k.y = reinterpret_cast<int8_t*>(smem + L.y);
  k.cap = reinterpret_cast<float*>(smem + L.cap);
  k.ring = smem_ring ? reinterpret_cast<float*>(smem + L.ring)
                     : scratch + (size_t)b * ring_floats * W;
  for (int i = tid; i < Q_SIZE; i += nt) k.tab[i] = tab[i];
  for (int i = tid; i < Lp; i += nt) {
    k.x[i] = X[(size_t)b * Lp + i];
    k.y[i] = Y[(size_t)b * Lp + i];
  }
  for (int i = tid; i < N_CAP; i += nt) k.cap[i] = LOG_ZERO;
  for (int i = tid; i < ring_floats * W; i += nt) k.ring[i] = LOG_ZERO;
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

template <bool SMEM_RING>
__global__ void __launch_bounds__(MAX_THREADS)
qpx_forward(const int8_t* __restrict__ X, const int8_t* __restrict__ Y,
            const int32_t* __restrict__ LX, const int32_t* __restrict__ LY,
            const float* __restrict__ tab, int B, int Lp,
            float* __restrict__ fwd_mp, float* __restrict__ total_f,
            float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Lp, SMEM_RING ? FWD_RING : 0);
  const Block k = prologue(smem, L, SMEM_RING, FWD_RING, X, Y, LX, LY, tab,
                           Lp, scratch);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int W = Lp + 1, D = 2 * Lp + 1, WB = W + 1;
  const int dterm = k.lx + k.ly;
  // buffer rows 0 and 1 (diagonals -2 and -1): the LOG_ZERO fill
  for (int i = tid; i < 2 * WB; i += nt)
    fwd_mp[((size_t)(i / WB) * B + b) * WB + i % WB] = LOG_ZERO;
  __syncthreads();
  const float* T = k.tab + Q_T;
  const float* i5 = k.tab + Q_INIT;
  const float* lm = k.tab + Q_LM;
  const float* li = k.tab + Q_LI;
  const float t00 = T[0];
  // per insert state x1, x2, y1, y2: into M, from M, self; init
  const float tk0[4] = {T[5], T[15], T[10], T[20]};
  const float t0q[4] = {T[1], T[3], T[2], T[4]};
  const float tqq[4] = {T[6], T[18], T[12], T[24]};
  const float i5q[4] = {i5[1], i5[3], i5[2], i5[4]};

  for (int d = 0; d < D; ++d) {
    float* Mn = k.ring + (d % 3) * W;
    const float* M1 = k.ring + ((d + 2) % 3) * W;
    const float* M2 = k.ring + ((d + 1) % 3) * W;
    float* In = k.ring + 3 * W + (d % 3) * 4 * W;
    const float* I1 = k.ring + 3 * W + ((d + 2) % 3) * 4 * W;
    const float* I2 = k.ring + 3 * W + ((d + 1) % 3) * 4 * W;
    float* orow = fwd_mp + ((size_t)(d + 2) * B + b) * WB;
    if (tid == 0) orow[0] = LOG_ZERO;
    for (int j = tid; j < W; j += nt) {
      const int i = d - j;
      const int xr = x_class(k.x, i, Lp);
      const int yg = j == 0 ? PAD : k.y[j - 1];
      const float em = lm[xr * NCLS + yg];
      // match: the chain over the five d-2 states at lane j-1, inserts
      // in the order x1, y1, x2, y2
      float acc = (j >= 1 ? M2[j - 1] : LOG_ZERO) + t00;
      acc = acc > HALF_LOG_ZERO ? acc : LOG_ZERO;
      const int order[4] = {0, 2, 1, 3};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = order[q];
        const float p2 = j >= 1 ? I2[s * W + j - 1] : LOG_ZERO;
        acc = log_add(acc, p2 == LOG_ZERO ? LOG_ZERO : p2 + tk0[s], k.tab);
      }
      float m_new = acc + em;
      if (d == 2 && j == 1) m_new = i5[0] + em;  // init cell (1, 1)
      const float mv = (i >= 1 && j >= 1) ? m_new : LOG_ZERO;
      orow[j + 1] = mv;
      Mn[j] = mv;
      if (d == dterm && j == k.ly) k.cap[4] = mv;
      // inserts: x from (i-1, j) at d-1, lane j; y from (i, j-1) at d-1,
      // lane j-1
      const float pmx = M1[j];
      const float pmy = j >= 1 ? M1[j - 1] : LOG_ZERO;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bool is_x = s < 2;
        const float pm = is_x ? pmx : pmy;
        const float ps = is_x ? I1[s * W + j]
                              : (j >= 1 ? I1[s * W + j - 1] : LOG_ZERO);
        const float a = pm == LOG_ZERO ? LOG_ZERO : pm + t0q[s];
        const float c = ps == LOG_ZERO ? LOG_ZERO : ps + tqq[s];
        const float ins = li[(s & 1) * NCLS + (is_x ? xr : yg)];
        float v = ins + log_add(a, c, k.tab);
        if (d == 1 && j == (is_x ? 0 : 1)) v = i5q[s] + ins;
        const bool mask = is_x ? (i >= 1) : (j >= 1 && i >= 0);
        const float val = mask ? v : LOG_ZERO;
        In[s * W + j] = val;
        if (d == dterm && j == k.ly) k.cap[s] = val;
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
      tf = log_add(tf, v == 0.0f ? LOG_ZERO : v + i5[q], k.tab);
    }
    total_f[b] = tf;
  }
}

template <bool SMEM_RING>
__global__ void __launch_bounds__(MAX_THREADS)
qpx_backward(const int8_t* __restrict__ X, const int8_t* __restrict__ Y,
             const int32_t* __restrict__ LX, const int32_t* __restrict__ LY,
             const float* __restrict__ tab, int B, int Lp,
             float* __restrict__ bwd_mp, const float* __restrict__ total_f,
             float* __restrict__ total, float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Lp, SMEM_RING ? BWD_RING : 0);
  const Block k = prologue(smem, L, SMEM_RING, BWD_RING, X, Y, LX, LY, tab,
                           Lp, scratch);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int W = Lp + 1, D = 2 * Lp + 1, WB = W + 1;
  const int dterm = k.lx + k.ly;
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

  for (int d = D - 1; d >= 0; --d) {
    float* Mn = k.ring + (d % 3) * W;
    const float* M2 = k.ring + ((d + 2) % 3) * W;
    float* In = k.ring + 3 * W + (d % 2) * 4 * W;
    const float* I1 = k.ring + 3 * W + ((d + 1) % 2) * 4 * W;
    float* orow = bwd_mp + ((size_t)d * B + b) * WB;
    if (tid == 0) orow[W] = LOG_ZERO;
    for (int j = tid; j < W; j += nt) {
      const int i = d - j;
      // next characters: x_{i+1} (diagonal d+1's x row), y_{j+1}
      const int xr1 = x_class(k.x, i + 1, Lp);
      const int yn = j < Lp ? k.y[j] : OFF;
      const float em_n = d <= D - 3 ? lm[xr1 * NCLS + yn] : LOG_ZERO;
      const float ixn[2] = {d <= D - 2 ? li[xr1] : LOG_ZERO,
                            d <= D - 2 ? li[NCLS + xr1] : LOG_ZERO};
      const float iyn[2] = {li[yn], li[NCLS + yn]};
      const bool mask_i = i < k.lx, mask_j = j < k.ly;
      const bool valid = i >= 0 && i <= k.lx && j <= k.ly;
      // ProbXY = b[i+1, j+1] + matchProb(c1, c2): d+2, lane j+1
      const float n2m = j + 1 < W ? M2[j + 1] : LOG_ZERO;
      const float pxy = n2m == LOG_ZERO ? LOG_ZERO : n2m + em_n;
      const bool pxy_ok = mask_i && mask_j && pxy != LOG_ZERO;
      float acc = pxy_ok ? pxy + t00 : LOG_ZERO;
      float ins_new[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bool is_x = s < 2;
        const float s4 = is_x ? I1[s * W + j]
                              : (j + 1 < W ? I1[s * W + j + 1] : LOG_ZERO);
        const float se = s4 + (is_x ? ixn[s] : iyn[s - 2]);
        const bool ok4 = (is_x ? mask_i : mask_j) && s4 != LOG_ZERO;
        // order into b: M, X1, X2, Y1, Y2
        acc = log_add(acc, ok4 ? se + tb4[s] : LOG_ZERO, k.tab);
        const float lvl = pxy_ok ? pxy + pt4[s] : LOG_ZERO;
        ins_new[s] = log_add(lvl, ok4 ? se + te4[s] : LOG_ZERO, k.tab);
      }
      if (d == dterm && j == k.ly) {  // terminal cell: initial distribution
        acc = i5[0];
#pragma unroll
        for (int s = 0; s < 4; ++s) ins_new[s] = i5b[s];
      }
      const float bm = valid ? acc : LOG_ZERO;
      orow[j] = bm;
      Mn[j] = bm;
      if (d == 2 && j == 1) k.cap[8] = bm;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float val = valid ? ins_new[s] : LOG_ZERO;
        In[s * W + j] = val;
        if (d == 1 && j <= 1) k.cap[4 * j + s] = val;
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
    tb = log_add(tb, (i5[1] + li[x1]) + k.cap[0], k.tab);
    tb = log_add(tb, (i5[2] + li[y1]) + k.cap[4 + 2], k.tab);
    tb = log_add(tb, (i5[3] + li[NCLS + x1]) + k.cap[1], k.tab);
    tb = log_add(tb, (i5[4] + li[NCLS + y1]) + k.cap[4 + 3], k.tab);
    total[b] = (total_f[b] + tb) * 0.5f;
  }
}

template <bool SMEM_RING>
cudaError_t launch(const int8_t* X, const int8_t* Y, const int32_t* LX,
                   const int32_t* LY, const float* tab, int B, int Lp,
                   float* fwd_mp, float* bwd_mp, float* total_f,
                   float* total, float* scratch, cudaStream_t stream) {
  const int nt = threads_for(Lp + 1);
  const size_t sf = layout(Lp, SMEM_RING ? FWD_RING : 0).total;
  const size_t sb = layout(Lp, SMEM_RING ? BWD_RING : 0).total;
  cudaError_t err;
  if (sf > 48 * 1024) {
    err = cudaFuncSetAttribute(qpx_forward<SMEM_RING>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sf);
    if (err != cudaSuccess) return err;
  }
  if (sb > 48 * 1024) {
    err = cudaFuncSetAttribute(qpx_backward<SMEM_RING>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sb);
    if (err != cudaSuccess) return err;
  }
  qpx_forward<SMEM_RING><<<B, nt, sf, stream>>>(X, Y, LX, LY, tab, B, Lp,
                                                fwd_mp, total_f, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qpx_backward<SMEM_RING><<<B, nt, sb, stream>>>(
      X, Y, LX, LY, tab, B, Lp, bwd_mp, total_f, total, scratch);
  return cudaGetLastError();
}

}  // namespace

// Floats of ring scratch a pair needs: 0 while the rings fit in shared
// memory; past SMEM_LANES lanes the caller passes B times this many (the
// backward reuses the forward's).
extern "C" int qpx_scratch_floats(int Lp) {
  return Lp + 1 <= SMEM_LANES ? 0 : FWD_RING * (Lp + 1);
}

extern "C" int qpx_launch(const void* X, const void* Y, const void* lx,
                          const void* ly, const void* tab, int B, int Lp,
                          void* fwd_mp, void* bwd_mp, void* total_f,
                          void* total, void* scratch, void* stream) {
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
  auto* tt = (float*)total;
  auto* s = (float*)scratch;
  auto st = (cudaStream_t)stream;
  cudaError_t err =
      smem_ring ? launch<true>(x, y, a, c, t, B, Lp, f, g, tf, tt, s, st)
                : launch<false>(x, y, a, c, t, B, Lp, f, g, tf, tt, s, st);
  return (int)err;
}
