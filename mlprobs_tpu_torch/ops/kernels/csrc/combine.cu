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
// Per model, p = f * r * 2^-(sf + sr + l2t) as the Pallas kernel's split
// power-of-two multiply: the exponent is split in two halves applied to
// f and to r before the product, so tiny x huge cells do not under- or
// overflow, and the only inexact factor is one exp2 of the fractional
// part per row.  r is the reverse plane's row 2Lp+2-d at lane Lp+1-j
// (rows and lanes out of range read as zero).  Totals: hmm5 and local
// average the forward and reverse totals, partition takes the forward
// one.  The models combine by RMS, sqrt(sum p^2 / n).
//
// Layout: one block per pair, one thread per lane (a strided loop over
// LPT lanes when W > 1024), a loop over diagonals inside the block.  The
// MWT DP carries s and n of diagonals d-1 and d-2 in registers and reads
// the j-1 neighbour from a double-buffered shared row (one barrier per
// diagonal).  The top-k runs k rounds of a block-wide (value, lane)
// arg-max, the lowest lane winning ties as in the JAX package's top_k,
// one barrier per round, and stops at the first round with nothing left
// >= cutoff.
//
// Bound on the H100: bytes.  Every cell of the 2 * nm input planes is
// read once and the dense plane written once, against a few dozen f32
// operations per cell.  The planes are read row by row with consecutive
// lanes on consecutive addresses (the reverse row in descending order);
// the posterior never leaves registers on the top-k path.  Built with
// --fmad=false so that each multiply and add rounds as the plain version
// does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PARTITION = 2;

__device__ __forceinline__ float pow2i(float e) {
  // exact 2**e for integer-valued e, clamped to the normal range
  int ei = (int)fminf(fmaxf(e, -126.f), 127.f);
  return __int_as_float((ei + 127) << 23);
}

template <int LPT>
__global__ void combine_kernel(const float* __restrict__ fwd,
                               const float* __restrict__ fsc,
                               const float* __restrict__ fl2t,
                               const float* __restrict__ rev,
                               const float* __restrict__ rsc,
                               const float* __restrict__ rl2t,
                               const int32_t* __restrict__ lxs,
                               const int32_t* __restrict__ lys, int nm,
                               int k0, int k1, int k2, int B, int Lp,
                               int with_matches, int topk, float cutoff,
                               float* __restrict__ post,
                               float* __restrict__ vals,
                               int32_t* __restrict__ lanes,
                               float* __restrict__ score,
                               float* __restrict__ nbs) {
  extern __shared__ float smem[];
  const int W = Lp + 1;
  const int D = 2 * Lp + 1;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31, nwarps = nt >> 5;
  const int b = blockIdx.x;
  const int lx = lxs[b], ly = lys[b];
  const int dterm = lx + ly;

  float* pub = smem;                      // [2][2][W]: s, n
  float* redv = smem + 4 * W;             // [2][32]
  int* redl = (int*)(redv + 64);          // [2][32]

  float l2t[3];
  int kinds[3] = {k0, k1, k2};
  for (int m = 0; m < nm; ++m) {
    const float f = fl2t[(size_t)m * B + b];
    l2t[m] = kinds[m] == PARTITION ? f
                                   : 0.5f * (f + rl2t[(size_t)m * B + b]);
  }

  float s1[LPT], s1s[LPT], s2s[LPT], n1[LPT], n1s[LPT], n2s[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    s1[k] = s1s[k] = s2s[k] = n1[k] = n1s[k] = n2s[k] = 0.f;
  float sc = 0.f, nbv = 0.f;
  int round = 0;

  for (int d = 0; d < D; ++d) {
    const int par = d & 1;
    const int rr = 2 * Lp + 2 - d;  // reverse row (>= 2 > 0 always)
    float prow[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) prow[k] = 0.f;
    for (int m = 0; m < nm; ++m) {
      const float sf = fsc[((size_t)m * D + d) * B + b];
      const float sr = rr < D ? rsc[((size_t)m * D + rr) * B + b] : 0.f;
      const float t = sf + sr + l2t[m];
      const float ti = floorf(t);
      const float a = floorf(-ti * 0.5f);
      const float b2 = -ti - a;
      const float c = exp2f(-(t - ti));
      const float pa = pow2i(a), pb = pow2i(b2);
      const float* frow = fwd + (((size_t)m * D + d) * B + b) * W;
      const float* rrow =
          rr < D ? rev + (((size_t)m * D + rr) * B + b) * W : nullptr;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = tid + k * nt;
        if (j >= W) continue;
        const float f = frow[j];
        const int jr = Lp + 1 - j;
        const float r = (rrow != nullptr && jr < W) ? rrow[jr] : 0.f;
        float p = (f * pa) * (r * pb) * c;
        p = fminf(p, 1.f);
        p = (f > 0.f && r > 0.f) ? p : 0.f;
        prow[k] = m == 0 ? p * p : prow[k] + p * p;
      }
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      prow[k] = nm == 1 ? sqrtf(prow[k]) : sqrtf(prow[k] / (float)nm);

    if (topk == 0) {
      float* orow = post + ((size_t)d * B + b) * W;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = tid + k * nt;
        if (j < W) orow[j] = prow[k];
      }
    } else {
      float rem[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = tid + k * nt;
        rem[k] = (j < W && prow[k] >= cutoff) ? prow[k] : 0.f;
      }
      float* vrow = vals + ((size_t)d * B + b) * topk;
      int32_t* lrow = lanes + ((size_t)d * B + b) * topk;
      for (int t = 0; t < topk; ++t) {
        // thread-local best: largest value, lowest lane among ties
        float bv = 0.f;
        int bl = 0x7fffffff;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int j = tid + k * nt;
          if (rem[k] > bv || (rem[k] == bv && rem[k] > 0.f && j < bl)) {
            bv = rem[k];
            bl = j;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
          if (ov > bv || (ov == bv && ol < bl)) {
            bv = ov;
            bl = ol;
          }
        }
        const int rp = round & 1;
        ++round;
        if (wl == 0) {
          redv[rp * 32 + warp] = bv;
          redl[rp * 32 + warp] = bl;
        }
        __syncthreads();
        bv = 0.f;
        bl = 0x7fffffff;
        for (int w = 0; w < nwarps; ++w) {
          const float ov = redv[rp * 32 + w];
          const int ol = redl[rp * 32 + w];
          if (ov > bv || (ov == bv && ol < bl)) {
            bv = ov;
            bl = ol;
          }
        }
        if (!(bv > 0.f)) {
          // nothing left >= cutoff: the remaining slots are empty
          for (int q = t + tid; q < topk; q += nt) {
            vrow[q] = 0.f;
            lrow[q] = 0;
          }
          break;
        }
        if (tid == 0) {
          vrow[t] = bv;
          lrow[t] = bl;
        }
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          if (tid + k * nt == bl) rem[k] = 0.f;
      }
    }

    // MWT accuracy DP (tie order diag >= left >= up)
    float* pb = pub + par * 2 * W;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = tid + k * nt;
      if (j >= W) continue;
      const int i = d - j;
      const float pd = prow[k] + s2s[k];
      const float left = s1s[k];
      const float up = s1[k];
      const bool take_d = pd >= left && pd >= up;
      const bool take_l = left >= up;
      const bool boundary = i <= 0 || j == 0;
      float s_new = take_d ? pd : (take_l ? left : up);
      if (boundary) s_new = 0.f;
      float n_new = 0.f;
      if (with_matches) {
        n_new = take_d ? n2s[k] + 1.f : (take_l ? n1s[k] : n1[k]);
        if (boundary) n_new = 0.f;
      }
      if (d == dterm && j == ly) {
        sc = s_new;
        nbv = n_new;
      }
      s1[k] = s_new;
      n1[k] = n_new;
      pb[j] = s_new;
      pb[W + j] = n_new;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = tid + k * nt;
      const bool in = j >= 1 && j < W;
      s2s[k] = s1s[k];
      n2s[k] = n1s[k];
      s1s[k] = in ? pb[j - 1] : 0.f;
      n1s[k] = in ? pb[W + j - 1] : 0.f;
    }
  }
  if (tid == ly % nt) {
    score[b] = sc;
    if (with_matches) nbs[b] = nbv;
  }
}

template <int LPT>
cudaError_t launch(int nt, const float* fwd, const float* fsc,
                   const float* fl2t, const float* rev, const float* rsc,
                   const float* rl2t, const int32_t* lx, const int32_t* ly,
                   int nm, int k0, int k1, int k2, int B, int Lp,
                   int with_matches, int topk, float cutoff, float* post,
                   float* vals, int32_t* lanes, float* score, float* nb,
                   cudaStream_t stream) {
  const int W = Lp + 1;
  const size_t smem = (4 * (size_t)W + 128) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        combine_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  combine_kernel<LPT><<<B, nt, smem, stream>>>(
      fwd, fsc, fl2t, rev, rsc, rl2t, lx, ly, nm, k0, k1, k2, B, Lp,
      with_matches, topk, cutoff, post, vals, lanes, score, nb);
  return cudaGetLastError();
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
  int lpt = W <= 1024 ? 1 : W <= 2048 ? 2 : W <= 4096 ? 4 : W <= 8192 ? 8 : 0;
  if (lpt == 0 || nm < 1 || nm > 3 || B < 1 || topk < 0 || topk > W)
    return (int)cudaErrorInvalidValue;
  const int nt = (((W + lpt - 1) / lpt) + 31) / 32 * 32;
#define ARGS                                                              \
  nt, (const float*)fwd, (const float*)fsc, (const float*)fl2t,           \
      (const float*)rev, (const float*)rsc, (const float*)rl2t,           \
      (const int32_t*)lx, (const int32_t*)ly, nm, k0, k1, k2, B, Lp,      \
      with_matches, topk, cutoff, (float*)post, (float*)vals,             \
      (int32_t*)lanes, (float*)score, (float*)nb, (cudaStream_t)stream
  cudaError_t err;
  switch (lpt) {
    case 1: err = launch<1>(ARGS); break;
    case 2: err = launch<2>(ARGS); break;
    case 4: err = launch<4>(ARGS); break;
    default: err = launch<8>(ARGS); break;
  }
#undef ARGS
  return (int)err;
}
