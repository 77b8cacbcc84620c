// Host helpers of the progressive merge: MWT fill and traceback over a
// dense profile posterior, and the weighted profile-posterior scatter.
//
// The port's own copy of the JAX package's native runtime functions
// mwt_fill / mwt_fill_dense and mwt_traceback
// (native/mlprobs_native.cpp), with the same arithmetic.  The scatter
// keeps the native runtime's interface but sums in the JAX package's
// numpy order, so that its plane does not depend on the thread count.
// Built with g++ at first use by utils/host.py.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

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
// ProbabilisticModel.h:1197-1379) into an (l1, l2) plane; optionally
// subtract w * cutoff at every mapped cell (the QuickProbs
// posteriorCutoff subtraction over ungapped rows x the first l2-1
// mapped columns).
//
// COO pool layout: pair p owns entries [pair_start[p],
// pair_start[p] + pair_len[p]) of coo_r / coo_c / coo_v (ungapped 0-based
// coordinates in its two sequences), sorted by coo_r.  maps1/maps2 pools
// hold each group member's ungapped-position -> profile-column map
// (ascending).
//
// The plane is the JAX package's numpy path's bit for bit
// (build_profile_posterior without a pool): an entry adds the f32
// product (float)w * v, a cell sums its entries in double in pair order
// (np.bincount), the subtractions w * cutoff sum in double in pair order
// into a second plane that is added after, and each cell is cast to f32
// once.  OpenMP splits the plane into bands of rows and each band walks
// every pair in order, so no cell's order of additions depends on the
// thread count or the schedule.  A pair's entries in a band are one
// contiguous run (the rows are sorted and the maps ascend), found by
// binary search, so the work stays O(entries + bands x pairs x log).
// A plane of fewer than kMinParallelBands bands (a realigned block's
// short profiles) runs on the calling thread: a team for one or two
// bands costs more than it splits, and waits on every busy core.
void profile_posterior(
    int l1, int l2,
    int npairs,
    const int64_t* pair_start,
    const int64_t* pair_len,
    const int32_t* a_idx,
    const int32_t* b_idx,
    const double* wts,
    const int32_t* coo_r,
    const int32_t* coo_c,
    const float* coo_v,
    const int32_t* maps1, const int64_t* map1_off,
    const int32_t* maps2, const int64_t* map2_off,
    double cutoff_sub,
    float* out
) {
    constexpr int kBand = 8;
    constexpr int kMinParallelBands = 4;
    const size_t plane = (size_t)l1 * l2;
    const bool with_sub = cutoff_sub != 0.0;
    std::vector<double> acc(plane, 0.0);
    std::vector<double> sub(with_sub ? plane : 0, 0.0);
    const int nbands = (l1 + kBand - 1) / kBand;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) if (nbands >= kMinParallelBands)
#endif
    for (int band = 0; band < nbands; ++band) {
        const int lo = band * kBand, hi = std::min(l1, lo + kBand);
        for (int p = 0; p < npairs; ++p) {
            const int32_t* m1 = maps1 + map1_off[a_idx[p]];
            const int32_t* m1_end = maps1 + map1_off[a_idx[p] + 1];
            const int32_t* m2 = maps2 + map2_off[b_idx[p]];
            // sequence rows r0..r1 land in profile rows [lo, hi)
            const int32_t r0 =
                (int32_t)(std::lower_bound(m1, m1_end, lo) - m1);
            const int32_t r1 =
                (int32_t)(std::lower_bound(m1 + r0, m1_end, hi) - m1);
            if (r0 == r1) continue;
            const int32_t* er = coo_r + pair_start[p];
            const int32_t* er_end = er + pair_len[p];
            const int32_t* e0 = std::lower_bound(er, er_end, r0);
            const int32_t* e1 = std::lower_bound(e0, er_end, r1);
            const float w = (float)wts[p];
            for (int64_t e = e0 - coo_r; e < e1 - coo_r; ++e) {
                const float wv = w * coo_v[e];
                acc[(size_t)m1[coo_r[e]] * l2 + m2[coo_c[e]]] += (double)wv;
            }
            if (with_sub) {
                const int64_t n2 =
                    map2_off[b_idx[p] + 1] - map2_off[b_idx[p]];
                const double s = wts[p] * cutoff_sub;
                for (int32_t r = r0; r < r1; ++r) {
                    double* row = sub.data() + (size_t)m1[r] * l2;
                    for (int64_t c = 0; c + 1 < n2; ++c) row[m2[c]] -= s;
                }
            }
        }
        for (size_t k = (size_t)lo * l2; k < (size_t)hi * l2; ++k)
            out[k] = (float)(with_sub ? acc[k] + sub[k] : acc[k]);
    }
}

}  // extern "C"
