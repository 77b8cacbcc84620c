// Host helpers of the progressive merge: MWT fill and traceback over a
// dense profile posterior, and the weighted profile-posterior scatter.
//
// The port's own copy of the JAX package's native runtime functions
// mwt_fill / mwt_fill_dense, mwt_traceback and profile_posterior
// (native/mlprobs_native.cpp), with the same arithmetic, so that the
// port's merges run the same host code as the JAX package's default.
// Built with g++ at first use by utils/host.py.
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Maximum-expected-accuracy DP over a 0-indexed-interior posterior
// plane laid out (lx+1)*(ly+1) with p(i, j) at [i*W + j] (1-indexed).
// ChooseBestOfThree tie order: diagonal >= left >= up
// (ProbabilisticModel.h:804-864, ScoreType.h:347-366).
float mwt_fill(const float *post, int lx, int ly, int8_t *dirs) {
    const int W = ly + 1;
    std::vector<float> s_prev(W, 0.0f), s(W);
    for (int j = 0; j <= ly; ++j) dirs[j] = 1;  // row 0: left
    for (int i = 1; i <= lx; ++i) {
        s[0] = 0.0f;
        dirs[(size_t)i * W] = 2;                // column 0: up
        for (int j = 1; j <= ly; ++j) {
            const float pd = post[(size_t)i * W + j] + s_prev[j - 1];
            const float left = s[j - 1];
            const float up = s_prev[j];
            if (pd >= left && pd >= up) {
                s[j] = pd;
                dirs[(size_t)i * W + j] = 0;
            } else if (left >= up) {
                s[j] = left;
                dirs[(size_t)i * W + j] = 1;
            } else {
                s[j] = up;
                dirs[(size_t)i * W + j] = 2;
            }
        }
        std::swap(s_prev, s);
    }
    return s_prev[ly];
}

}  // namespace

extern "C" {

// Dense MWT fill for the progressive/refinement profile DP.  post is the
// 0-based (lx, ly) plane; dirs is (lx+1)*(ly+1).  Returns the score.
float mwt_fill_dense(const float *post, int lx, int ly, int8_t *dirs) {
    const int W = ly + 1;
    std::vector<float> plane((size_t)(lx + 1) * W, 0.0f);
    for (int i = 1; i <= lx; ++i)
        std::memcpy(plane.data() + (size_t)i * W + 1,
                    post + (size_t)(i - 1) * ly, ly * sizeof(float));
    return mwt_fill(plane.data(), lx, ly, dirs);
}

// Walk one MWT direction matrix (0=diag, 1=left, 2=up) from (lx, ly).
// dirs has row stride `stride`. Writes path codes (0='B',1='X',2='Y')
// in forward order into out (capacity lx+ly); returns path length.
int mwt_traceback(const int8_t* dirs, int stride, int lx, int ly,
                  int8_t* out) {
    int r = lx, c = ly, n = 0;
    int8_t* rev = out;  // fill backwards then reverse
    while (r != 0 || c != 0) {
        int8_t d = dirs[r * stride + c];
        if (d == 0) { --r; --c; rev[n++] = 0; }
        else if (d == 1) { --c; rev[n++] = 2; }
        else { --r; rev[n++] = 1; }
    }
    for (int i = 0; i < n / 2; ++i) {
        int8_t t = out[i]; out[i] = out[n - 1 - i]; out[n - 1 - i] = t;
    }
    return n;
}

// Weighted profile-posterior scatter (BuildPosterior,
// ProbabilisticModel.h:1197-1379) into a caller-zeroed (l1, l2) plane;
// optionally subtract w * cutoff at every mapped cell (the QuickProbs
// posteriorCutoff subtraction over ungapped rows x the first l2-1
// mapped columns).
//
// COO pool layout: pair p owns entries [pair_start[p],
// pair_start[p] + pair_len[p]) of coo_r / coo_c / coo_v (ungapped 0-based
// coordinates in its two sequences).  maps1/maps2 pools hold each group
// member's ungapped-position -> profile-column map.
//
// OpenMP over pairs with per-thread accumulation planes, reduced at the
// end (the reference's row-block parallel variant).
void profile_posterior(
    int l1, int l2,
    int npairs,
    const int64_t* pair_start,
    const int64_t* pair_len,
    const int32_t* a_idx,
    const int32_t* b_idx,
    const float* wts,
    const int32_t* coo_r,
    const int32_t* coo_c,
    const float* coo_v,
    const int32_t* maps1, const int64_t* map1_off,
    const int32_t* maps2, const int64_t* map2_off,
    float cutoff_sub,
    float* out
) {
    const size_t plane = (size_t)l1 * l2;
#ifdef _OPENMP
    int nthreads = omp_get_max_threads();
#else
    int nthreads = 1;
#endif
    std::vector<std::vector<double>> acc(
        nthreads, std::vector<double>(plane, 0.0));

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int p = 0; p < npairs; ++p) {
#ifdef _OPENMP
        double* A = acc[omp_get_thread_num()].data();
#else
        double* A = acc[0].data();
#endif
        const int32_t* m1 = maps1 + map1_off[a_idx[p]];
        const int32_t* m2 = maps2 + map2_off[b_idx[p]];
        const double w = wts[p];
        const int64_t e0 = pair_start[p], e1 = e0 + pair_len[p];
        for (int64_t e = e0; e < e1; ++e) {
            A[(size_t)m1[coo_r[e]] * l2 + m2[coo_c[e]]] += w * coo_v[e];
        }
        if (cutoff_sub != 0.0f) {
            const int64_t n1 =
                map1_off[a_idx[p] + 1] - map1_off[a_idx[p]];
            const int64_t n2 =
                map2_off[b_idx[p] + 1] - map2_off[b_idx[p]];
            const double sub = w * (double)cutoff_sub;
            for (int64_t r = 0; r < n1; ++r) {
                double* row = A + (size_t)m1[r] * l2;
                for (int64_t c = 0; c + 1 < n2; ++c) {
                    row[m2[c]] -= sub;
                }
            }
        }
    }
    for (int t = 0; t < nthreads; ++t) {
        const double* A = acc[t].data();
        for (size_t k = 0; k < plane; ++k) out[k] += (float)A[k];
    }
}

}  // extern "C"
