// Forward wavefront sweep of the pair-HMM / partition-function models.
//
// Replaces the Pallas TPU kernel `sweep` (mlprobs_tpu/ops/pallas/
// wavefront_kernel.py, `_sweep_jit` / `_sweep_kernel_body`).  Same
// contract as the plain PyTorch version (ops/wavefront.py,
// `wavefront_forward`): for each requested model, the (D, B, W) plane of
// the M (or Zm) state -- or with emit_pre the pre-emission accumulator --
// the (D, B) log2 scale of every diagonal and the (B,) log2 total.
// D = 2*Lp + 1 rows, W = Lp + 1 lanes; row d, lane j is grid cell
// (d - j, j).
//
// Layout: one block per (pair, model), one thread per lane j (a strided
// loop over LPT lanes when W > 1024).  The loop over diagonals runs
// inside the block: Hopper's blocks run in parallel and in no order, so
// the TPU's sequential grid axis becomes this loop.  A model's states of
// diagonals d-1 and d-2 stay in registers.  The (., j-1) dependency is
// read from a double-buffered shared-memory row: after each diagonal
// every lane publishes the three sums its right neighbour needs (A: the
// weighted d-2 sum that feeds M two diagonals later; B1, B2: the d-1
// sums that feed the Y states or Ze on the next diagonal).  The sums are
// formed in the plain version's order, so shifting the sum equals the
// sum of the shifted states.  The power-of-two rescale takes a block max
// (warp shuffles, then one shared row of per-warp values); the local
// model's row sum rides in the same reduction.  Two barriers per
// diagonal.  pm (21 x 21) sits in shared memory and each lane looks up
// pm[x_{d-j}][y_j]; y_j and the hmm5 insert emissions pins[y_j] stay in
// registers for the whole sweep.
//
// Bound on the H100: bytes.  Each diagonal writes one plane row per
// model, (nm * D * B * W + nm * D * B) * 4 bytes in all, while the
// arithmetic is a few dozen f32 operations per cell.  The design keeps
// every DP state on chip, so the planes are the only traffic; the rows
// are written whole by consecutive lanes (coalesced).  Built with
// --fmad=false so that each multiply and add rounds as the plain version
// does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float exp2i(float e) {
  // exact 2**e for integer-valued e, underflowing to 0 and overflowing to
  // inf as the plain version's exp2 does
  return ldexpf(1.f, (int)fminf(fmaxf(e, -1000.f), 1000.f));
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KIND, int LPT>
__device__ void sweep_one(const int8_t* __restrict__ X,
                          const int8_t* __restrict__ Y, int ox, int oy,
                          int lx, int ly, const float* __restrict__ tab,
                          int B, int Lp, int emit_pre, int b, int mi,
                          float* __restrict__ planes,
                          float* __restrict__ scales,
                          float* __restrict__ l2t, float* smem) {
  constexpr int NS = KIND == HMM5 ? 5 : 3;
  const int W = Lp + 1;
  const int D = 2 * Lp + 1;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31, nwarps = nt >> 5;

  // shared: pm table, double-buffered publish rows, reduction rows
  float* pm = smem;                       // 441 (+pad)
  float* pub = smem + 448;                // [2][3][W]
  float* red = pub + 6 * W;               // [2][2][32]
  for (int k = tid; k < 441; k += nt) pm[k] = tab[TAB_PM + k];

  float T[25];
  for (int k = 0; k < 25; ++k) T[k] = tab[TAB_T + k];
  float init[5];
  for (int k = 0; k < 5; ++k) init[k] = tab[TAB_INIT + k];
  const float c1 = tab[TAB_C1], c2 = tab[TAB_C2];
  const float go = tab[TAB_GO], ge = tab[TAB_GE];
  const int nT = KIND == HMM5 ? 5 : 3;  // row stride of T
  const int dterm = ox + lx + oy + ly;
  const int8_t* xrow = X + (size_t)b * Lp;

  float st[LPT][NS];
  float a_cur[LPT], a_next[LPT], b1s[LPT], b2s[LPT];
  int yc[LPT];
  float iy0[LPT], iy1[LPT];
  float term[NS];
  for (int s = 0; s < NS; ++s) term[s] = 0.f;
  float sterm = 0.f;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int j = tid + k * nt;
#pragma unroll
    for (int s = 0; s < NS; ++s) st[k][s] = 0.f;
    a_cur[k] = a_next[k] = b1s[k] = b2s[k] = 0.f;
    int y = PAD;
    if (j >= 1 && j < W) y = Y[(size_t)b * Lp + j - 1];
    yc[k] = y;
    iy0[k] = tab[TAB_PINS + 2 * y];
    iy1[k] = tab[TAB_PINS + 2 * y + 1];
  }
  float rc = 1.f, s1 = 0.f, acc = -INFINITY;
  __syncthreads();

  for (int d = 0; d < D; ++d) {
    const int par = d & 1;
    const float e2s1 = exp2i(s1);
    float nv[LPT][NS];
    float amv[LPT];
    float mx = 0.f, rs = 0.f;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = tid + k * nt;
      const int i = d - j;
      int xc = PAD;
      if (i >= 1 && i <= Lp && j < W) xc = xrow[i - 1];
      const float em = pm[xc * 21 + yc[k]];
      if constexpr (KIND == HMM5) {
        const float m1 = st[k][0], x11 = st[k][1], x21 = st[k][3];
        const float ix0 = tab[TAB_PINS + 2 * xc];
        const float ix1 = tab[TAB_PINS + 2 * xc + 1];
        const float inj_m =
            (d == ox + oy + 2 && j == oy + 1) ? init[0] * e2s1 : 0.f;
        const float am = a_cur[k] * rc + inj_m;
        const bool injx = d == ox + oy + 1 && j == oy;
        const bool injy = d == ox + oy + 1 && j == oy + 1;
        nv[k][0] = em * am;
        nv[k][1] = ix0 * ((m1 * T[0 * nT + 1] + x11 * T[1 * nT + 1]) +
                          (injx ? init[1] * e2s1 : 0.f));
        nv[k][2] = iy0[k] * (b1s[k] + (injy ? init[2] * e2s1 : 0.f));
        nv[k][3] = ix1 * ((m1 * T[0 * nT + 3] + x21 * T[3 * nT + 3]) +
                          (injx ? init[3] * e2s1 : 0.f));
        nv[k][4] = iy1[k] * (b2s[k] + (injy ? init[4] * e2s1 : 0.f));
        amv[k] = am;
      } else if constexpr (KIND == LOCAL) {
        const float m1 = st[k][0], x1 = st[k][1];
        const bool inb = i > ox && i <= ox + lx && j > oy && j <= oy + ly;
        const float am = a_cur[k] * rc + (inb ? e2s1 : 0.f);
        nv[k][0] = em * c2 * am;
        nv[k][1] = c1 * (m1 * T[0 * nT + 1] + x1 * T[1 * nT + 1]);
        nv[k][2] = c1 * b1s[k];
        amv[k] = am;
      } else {
        const float zm1 = st[k][0], zf1 = st[k][2];
        const bool row0 = i == ox, col0 = j == oy, x_done = i == ox + lx;
        const bool lane_end = j == oy + ly;
        const bool inb = i >= ox && i <= ox + lx && j >= oy && j <= oy + ly;
        float am = a_cur[k] * rc;
        float zm = em * am;
        if (row0 && col0 && inb) zm = e2s1;
        const float gof = (col0 || lane_end) ? 1.f : go;
        const float gef = (col0 || lane_end) ? 1.f : ge;
        float zf = zm1 * gof + zf1 * gef;
        if (col0 && i > ox) zf = e2s1;
        const float goe = x_done ? 1.f : go;
        const float gee = x_done ? 1.f : ge;
        float ze = b1s[k] * goe + b2s[k] * gee;
        if (row0 && j > oy) ze = e2s1;
        if (!inb) zm = zf = ze = am = 0.f;
        nv[k][0] = zm;
        nv[k][1] = ze;
        nv[k][2] = zf;
        amv[k] = am;
      }
      if (j < W) {
#pragma unroll
        for (int s = 0; s < NS; ++s) mx = fmaxf(mx, nv[k][s]);
        if constexpr (KIND == LOCAL) rs += nv[k][0];
      }
    }
    // block max (and the local model's row sum) in one reduction round
    mx = warp_max(mx);
    if constexpr (KIND == LOCAL) rs = warp_sum(rs);
    float* rb = red + par * 64;
    if (wl == 0) {
      rb[warp] = mx;
      rb[32 + warp] = rs;
    }
    __syncthreads();
    mx = 0.f;
    rs = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      mx = fmaxf(mx, rb[w]);
      if constexpr (KIND == LOCAL) rs += rb[32 + w];
    }
    const float e = floor_log2(mx);
    const float f = exp2i(-e);
    const float s_new = s1 - e;
    if constexpr (KIND == LOCAL) {
      const float rowsum = rs * f;
      const float t = rowsum > 0.f
                          ? log2f(fmaxf(rowsum, TINY)) - s_new
                          : -INFINITY;
      acc = logaddexp2f(acc, t);
    }
    float* prow = planes + (((size_t)mi * D + d) * B + b) * W;
    float* pb = pub + par * 3 * W;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = tid + k * nt;
#pragma unroll
      for (int s = 0; s < NS; ++s) st[k][s] = nv[k][s] * f;
      if (j < W) {
        prow[j] = emit_pre ? amv[k] * f : st[k][0];
        float A, B1, B2 = 0.f;
        if constexpr (KIND == HMM5) {
          const float m = st[k][0], x1 = st[k][1], y1 = st[k][2];
          const float x2 = st[k][3], y2 = st[k][4];
          A = m * T[0 * nT + 0] + x1 * T[1 * nT + 0] + y1 * T[2 * nT + 0] +
              x2 * T[3 * nT + 0] + y2 * T[4 * nT + 0];
          B1 = m * T[0 * nT + 2] + y1 * T[2 * nT + 2];
          B2 = m * T[0 * nT + 4] + y2 * T[4 * nT + 4];
        } else if constexpr (KIND == LOCAL) {
          const float m = st[k][0], x = st[k][1], y = st[k][2];
          A = m * T[0 * nT + 0] + x * T[1 * nT + 0] + y * T[2 * nT + 0];
          B1 = m * T[0 * nT + 2] + y * T[2 * nT + 2];
        } else {
          A = (st[k][0] + st[k][1]) + st[k][2];
          B1 = st[k][0];
          B2 = st[k][1];
        }
        pb[j] = A;
        pb[W + j] = B1;
        pb[2 * W + j] = B2;
        if constexpr (KIND != LOCAL) {
          if (d == dterm && j == oy + ly) {
#pragma unroll
            for (int s = 0; s < NS; ++s) term[s] = st[k][s];
            sterm = s_new;
          }
        }
      }
    }
    if (tid == 0) scales[((size_t)mi * D + d) * B + b] = s_new;
    rc = f;
    s1 = s_new;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = tid + k * nt;
      a_cur[k] = a_next[k];
      const bool in = j >= 1 && j < W;
      a_next[k] = in ? pb[j - 1] : 0.f;
      b1s[k] = in ? pb[W + j - 1] : 0.f;
      b2s[k] = in ? pb[2 * W + j - 1] : 0.f;
    }
  }

  if constexpr (KIND == LOCAL) {
    if (tid == 0) l2t[(size_t)mi * B + b] = acc;
  } else {
    // the owner of lane oy+ly captured the terminal states
    const int jt = oy + ly;
    if (tid == jt % nt) {
      float tot;
      if constexpr (KIND == HMM5) {
        tot = 0.f;
        for (int s = 0; s < 5; ++s) tot = tot + term[s] * init[s];
      } else {
        tot = term[0] + term[1] + term[2];
      }
      l2t[(size_t)mi * B + b] = log2f(fmaxf(tot, TINY)) - sterm;
    }
  }
}

template <int LPT>
__global__ void sweep_kernel(const int8_t* X, const int8_t* Y,
                             const int32_t* ox, const int32_t* oy,
                             const int32_t* lx, const int32_t* ly,
                             const float* tabs, int k0, int k1, int k2,
                             int B, int Lp, int emit_pre, float* planes,
                             float* scales, float* l2t) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, mi = blockIdx.y;
  const int kind = mi == 0 ? k0 : (mi == 1 ? k1 : k2);
  const float* tab = tabs + (size_t)mi * TAB_SIZE;
  if (kind == HMM5)
    sweep_one<HMM5, LPT>(X, Y, ox[b], oy[b], lx[b], ly[b], tab, B, Lp,
                         emit_pre, b, mi, planes, scales, l2t, smem);
  else if (kind == LOCAL)
    sweep_one<LOCAL, LPT>(X, Y, ox[b], oy[b], lx[b], ly[b], tab, B, Lp,
                          emit_pre, b, mi, planes, scales, l2t, smem);
  else
    sweep_one<PARTITION, LPT>(X, Y, ox[b], oy[b], lx[b], ly[b], tab, B,
                              Lp, emit_pre, b, mi, planes, scales, l2t,
                              smem);
}

template <int LPT>
cudaError_t launch(int nt, const int8_t* X, const int8_t* Y,
                   const int32_t* ox, const int32_t* oy, const int32_t* lx,
                   const int32_t* ly, const float* tabs, int nm, int k0,
                   int k1, int k2, int B, int Lp, int emit_pre,
                   float* planes, float* scales, float* l2t,
                   cudaStream_t stream) {
  const int W = Lp + 1;
  const size_t smem = (448 + 6 * (size_t)W + 128) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, nm);
  sweep_kernel<LPT><<<grid, nt, smem, stream>>>(X, Y, ox, oy, lx, ly, tabs,
                                                k0, k1, k2, B, Lp, emit_pre,
                                                planes, scales, l2t);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sweep_launch(const void* X, const void* Y, const void* ox,
                            const void* oy, const void* lx, const void* ly,
                            const void* tabs, int nm, int k0, int k1, int k2,
                            int B, int Lp, int emit_pre, void* planes,
                            void* scales, void* l2t, void* stream) {
  const int W = Lp + 1;
  int lpt = W <= 1024 ? 1 : W <= 2048 ? 2 : W <= 4096 ? 4 : W <= 8192 ? 8 : 0;
  if (lpt == 0 || nm < 1 || nm > 3 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nt = (((W + lpt - 1) / lpt) + 31) / 32 * 32;
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
  switch (lpt) {
    case 1:
      err = launch<1>(nt, x, y, a, c, e, g, t, nm, k0, k1, k2, B, Lp,
                      emit_pre, p, s, l, st);
      break;
    case 2:
      err = launch<2>(nt, x, y, a, c, e, g, t, nm, k0, k1, k2, B, Lp,
                      emit_pre, p, s, l, st);
      break;
    case 4:
      err = launch<4>(nt, x, y, a, c, e, g, t, nm, k0, k1, k2, B, Lp,
                      emit_pre, p, s, l, st);
      break;
    default:
      err = launch<8>(nt, x, y, a, c, e, g, t, nm, k0, k1, k2, B, Lp,
                      emit_pre, p, s, l, st);
      break;
  }
  return (int)err;
}
