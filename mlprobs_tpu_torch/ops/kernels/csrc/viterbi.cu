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
// ~20 f32 adds, maxes and compares a cell.  Neither is the limit: each
// diagonal needs the two before it, so a pair is a chain of 2*Lp + 1
// steps, and the latency of one step (a few shared-memory loads, the max
// tree, one barrier) sets the time.  The traceback is a chain of up to
// 2*Lp dependent loads from the plane, one pair at a time.
//
// Layout.  One block per pair; the loop over diagonals runs inside it
// with one barrier a diagonal.  This is the simplest design that keeps
// every dependency on chip: the states of diagonals d-1 and d-2 (three
// rows each, M, X and Y) sit in a ring of three rows, read at lane j and
// j-1 and written at lane j, so one barrier a diagonal orders every
// write after every read of the slot it reuses.  A thread owns the lanes
// j = tid, tid + nt, ...; nt is half the lanes rounded up to a warp, at
// most 1,024.  Up to SMEM_LANES lanes the ring is in shared memory;
// past that (sequences of more than 4,095 residues) it is a per-pair
// slice of a scratch buffer that the wrapper allocates, which stays in
// the L2 cache, and the block's barrier orders its global writes and
// reads as it does the shared ones.  After the last diagonal, thread 0
// walks the pair's path through the plane exactly as the plain version
// does, one step a loop, while the other threads wait; the steps past the
// path's end get the plain version's zeros.
//
// Arithmetic.  Max-plus in f32: adds, maxes and compares only, in the
// plain version's order and with its tie-breaks, so every output equals
// the plain version's bit for bit.  The (., j-1) dependency at lane 0 is
// the plain version's zero fill (F.pad), not LOG_ZERO.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 20;
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_LANES = 4096;
constexpr int MAX_LP = 65536;

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
  size_t x, y, ring, term, total;
};

__host__ __device__ inline Layout layout(int Lp, bool smem_ring) {
  Layout L;
  L.x = T_FLOATS * sizeof(float);
  L.y = L.x + round16(Lp);
  L.ring = L.y + round16(Lp);
  L.term = L.ring + (smem_ring ? 9 * (size_t)(Lp + 1) * sizeof(float) : 0);
  L.total = L.term + 4 * sizeof(float) + 16;
  return L;
}

inline int threads_for(int W) {
  const int half = (W + 1) / 2;
  const int nt = (half + 31) / 32 * 32;
  return nt < MAX_THREADS ? nt : MAX_THREADS;
}

template <bool SMEM_RING>
__global__ void __launch_bounds__(MAX_THREADS)
viterbi_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Y,
               const int32_t* __restrict__ LX,
               const int32_t* __restrict__ LY,
               const float* __restrict__ tab, int B, int Lp,
               int8_t* __restrict__ dirs, int32_t* __restrict__ end_state,
               float* __restrict__ score, int32_t* __restrict__ pathlen,
               int32_t* __restrict__ matches, float* __restrict__ scores_rev,
               float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Lp, SMEM_RING);
  float* s_tab = reinterpret_cast<float*>(smem);
  int8_t* s_x = reinterpret_cast<int8_t*>(smem + L.x);
  int8_t* s_y = reinterpret_cast<int8_t*>(smem + L.y);
  float* s_term = reinterpret_cast<float*>(smem + L.term);
  int* s_stop = reinterpret_cast<int*>(s_term + 3);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = Lp + 1, D = 2 * Lp + 1;
  float* ring = SMEM_RING ? reinterpret_cast<float*>(smem + L.ring)
                          : scratch + (size_t)b * 9 * W;

  for (int k = tid; k < T_SIZE; k += nt) s_tab[k] = tab[k];
  for (int k = tid; k < Lp; k += nt) {
    s_x[k] = X[(size_t)b * Lp + k];
    s_y[k] = Y[(size_t)b * Lp + k];
  }
  for (int k = tid; k < 9 * W; k += nt) ring[k] = -1e30f;  // LOG_ZERO
  if (tid < 3) s_term[tid] = 0.0f;
  // lengths past Lp (which the plain version cannot index) are clamped,
  // so that no read leaves the pair's rows
  const int lx = min(max(LX[b], 0), Lp), ly = min(max(LY[b], 0), Lp);
  const int dterm = lx + ly;
  __syncthreads();

  const float* lm = s_tab + T_LM;
  const float* lins = s_tab + T_LINS;
  const float t00 = s_tab[T_TRANS + 0], t01 = s_tab[T_TRANS + 1],
              t02 = s_tab[T_TRANS + 2], t10 = s_tab[T_TRANS + 3],
              t11 = s_tab[T_TRANS + 4], t20 = s_tab[T_TRANS + 6],
              t22 = s_tab[T_TRANS + 8];

  for (int d = 0; d < D; ++d) {
    float* nw = ring + (d % 3) * 3 * W;              // diagonal d
    const float* p1 = ring + ((d + 2) % 3) * 3 * W;  // d - 1
    const float* p2 = ring + ((d + 1) % 3) * 3 * W;  // d - 2
    int8_t* drow = dirs + ((size_t)d * B + b) * W;
    for (int j = tid; j < W; j += nt) {
      const int i = d - j;
      const int xc = (i >= 1 && i <= Lp) ? s_x[i - 1] : PAD;
      const int yc = j == 0 ? PAD : s_y[j - 1];
      const float em = lm[xc * 21 + yc];
      // (., j-1) states: the plain version's zero fill at lane 0
      float m2l = 0.0f, x2l = 0.0f, y2l = 0.0f, m1l = 0.0f, y1l = 0.0f;
      if (j > 0) {
        m2l = p2[j - 1];
        x2l = p2[W + j - 1];
        y2l = p2[2 * W + j - 1];
        m1l = p1[j - 1];
        y1l = p1[2 * W + j - 1];
      }
      const float cm = m2l + t00;
      const float cx = x2l + t10;
      const float cy = y2l + t20;
      float m_new = em + fmaxf(fmaxf(cm, cx), cy);
      const int tb_m = (cm >= cx && cm >= cy) ? 0 : (cx >= cy ? 1 : 2);
      const float from_m = p1[j] + t01;
      const float from_x = p1[W + j] + t11;
      float x_new = lins[xc] + fmaxf(from_m, from_x);
      const int tb_x = from_m < from_x ? 1 : 0;
      const float ym = m1l + t02;
      const float yy = y1l + t22;
      float y_new = lins[yc] + fmaxf(ym, yy);
      const int tb_y = ym < yy ? 1 : 0;
      if (d == 0 && j == 0) {
        m_new = s_tab[T_VINIT + 0];
        x_new = s_tab[T_VINIT + 1];
        y_new = s_tab[T_VINIT + 2];
      }
      drow[j] = (int8_t)(tb_m + 4 * tb_x + 8 * tb_y);
      if (d == dterm && j == ly) {
        s_term[0] = m_new;
        s_term[1] = x_new;
        s_term[2] = y_new;
      }
      nw[j] = m_new;
      nw[W + j] = x_new;
      nw[2 * W + j] = y_new;
    }
    __syncthreads();
  }

  if (tid == 0) {
    const float f0 = s_term[0] + s_tab[T_VINIT + 0];
    const float f1 = s_term[1] + s_tab[T_VINIT + 1];
    const float f2 = s_term[2] + s_tab[T_VINIT + 2];
    const int es = (f0 >= f1 && f0 >= f2) ? 0 : (f1 >= f2 ? 1 : 2);
    end_state[b] = es;
    score[b] = es == 0 ? f0 : (es == 1 ? f1 : f2);
    // traceback: the plain version's lockstep walk, one pair; an index
    // below zero wraps as a torch index does
    const float* bl = s_tab + T_BLOSUM;
    int r = lx, c = ly, state = es, plen = 0, nmatch = 0, t = 0;
    for (; t < 2 * Lp && (r > 0 || c > 0); ++t) {
      const int rc = r + c < 0 ? r + c + D : r + c;
      const int cc = c < 0 ? c + W : c;
      const int dbits = dirs[((size_t)rc * B + b) * W + cc];
      const int nxt = state == 0 ? (dbits & 3)
                      : state == 1 ? ((dbits & 4) ? 1 : 0)
                                   : ((dbits & 8) ? 2 : 0);
      const int xc = s_x[r - 1 > 0 ? r - 1 : 0];
      const int yc = s_y[c - 1 > 0 ? c - 1 : 0];
      const bool is_b = state == 0;
      nmatch += (is_b && xc == yc) ? 1 : 0;
      const float s = bl[xc * 21 + yc];
      scores_rev[(size_t)t * B + b] =
          (is_b && xc < PAD && yc < PAD && s < 10.0f) ? s : 0.0f;
      plen += 1;
      if (state == 0 || state == 1) r -= 1;
      if (state == 0 || state == 2) c -= 1;
      state = nxt;
    }
    pathlen[b] = plen;
    matches[b] = nmatch;
    *s_stop = t;
  }
  __syncthreads();
  for (int t = *s_stop + tid; t < 2 * Lp; t += nt)
    scores_rev[(size_t)t * B + b] = 0.0f;
}

template <bool SMEM_RING>
cudaError_t launch(const int8_t* X, const int8_t* Y, const int32_t* LX,
                   const int32_t* LY, const float* tab, int B, int Lp,
                   int8_t* dirs, int32_t* es, float* sc, int32_t* plen,
                   int32_t* nm, float* srev, float* scratch,
                   cudaStream_t stream) {
  const size_t smem = layout(Lp, SMEM_RING).total;
  auto kern = viterbi_kernel<SMEM_RING>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<B, threads_for(Lp + 1), smem, stream>>>(
      X, Y, LX, LY, tab, B, Lp, dirs, es, sc, plen, nm, srev, scratch);
  return cudaGetLastError();
}

}  // namespace

// Floats of ring scratch a pair needs: 0 while the rings fit in shared
// memory; past SMEM_LANES lanes the caller passes B times this many.
extern "C" int viterbi_scratch_floats(int Lp) {
  return Lp + 1 <= SMEM_LANES ? 0 : 9 * (Lp + 1);
}

extern "C" int viterbi_launch(const void* X, const void* Y, const void* lx,
                              const void* ly, const void* tab, int B, int Lp,
                              void* dirs, void* end_state, void* score,
                              void* pathlen, void* matches, void* scores_rev,
                              void* scratch, void* stream) {
  if (Lp < 1 || Lp > MAX_LP || B < 1) return (int)cudaErrorInvalidValue;
  const bool smem_ring = Lp + 1 <= SMEM_LANES;
  if (!smem_ring && scratch == nullptr) return (int)cudaErrorInvalidValue;
  auto* x = (const int8_t*)X;
  auto* y = (const int8_t*)Y;
  auto* a = (const int32_t*)lx;
  auto* c = (const int32_t*)ly;
  auto* t = (const float*)tab;
  auto* dr = (int8_t*)dirs;
  auto* es = (int32_t*)end_state;
  auto* sc = (float*)score;
  auto* pl = (int32_t*)pathlen;
  auto* nm = (int32_t*)matches;
  auto* sr = (float*)scores_rev;
  auto* scr = (float*)scratch;
  auto st = (cudaStream_t)stream;
  cudaError_t err =
      smem_ring
          ? launch<true>(x, y, a, c, t, B, Lp, dr, es, sc, pl, nm, sr, scr, st)
          : launch<false>(x, y, a, c, t, B, Lp, dr, es, sc, pl, nm, sr, scr,
                          st);
  return (int)err;
}
