// Walker/Vose alias-table construction for O(1) discrete sampling.
//
// The renderer replaces the reference envmap emitter's hierarchical
// 2D CDF binary search (/root/reference/src/emitters/envmap.cpp, sampling
// via Distribution2D-style tables) with alias tables: a per-lane binary
// search is a ~20-iteration gather loop per lane, while an
// alias sample is two gathers and a compare.  Construction is inherently
// sequential per distribution, so it lives here in native code; rows of a
// 2D conditional table are independent and trivially batched.
//
// Exact per-cell probabilities are preserved: prob[i] is the acceptance
// threshold, alias[i] the donor cell.  Built in double precision.
#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// One alias table over n weights (need not be normalized).
// prob_out: (n,) f32 acceptance thresholds; alias_out: (n,) i32 donors.
void mitpu_build_alias(int64_t n, const float *w, float *prob_out,
                       int32_t *alias_out) {
    if (n <= 0) return;
    double total = 0.0;
    for (int64_t i = 0; i < n; i++) total += (double)(w[i] > 0 ? w[i] : 0);
    std::vector<double> scaled((size_t)n);
    if (total <= 0) {
        for (int64_t i = 0; i < n; i++) scaled[(size_t)i] = 1.0;
    } else {
        for (int64_t i = 0; i < n; i++)
            scaled[(size_t)i] = (double)(w[i] > 0 ? w[i] : 0) * n / total;
    }
    std::vector<int32_t> small, large;
    small.reserve((size_t)n); large.reserve((size_t)n);
    for (int64_t i = 0; i < n; i++) {
        if (scaled[(size_t)i] < 1.0) small.push_back((int32_t)i);
        else large.push_back((int32_t)i);
    }
    for (int64_t i = 0; i < n; i++) { prob_out[i] = 1.0f; alias_out[i] = (int32_t)i; }
    while (!small.empty() && !large.empty()) {
        int32_t s = small.back(); small.pop_back();
        int32_t l = large.back(); large.pop_back();
        prob_out[s] = (float)scaled[(size_t)s];
        alias_out[s] = l;
        scaled[(size_t)l] = (scaled[(size_t)l] + scaled[(size_t)s]) - 1.0;
        if (scaled[(size_t)l] < 1.0) small.push_back(l);
        else large.push_back(l);
    }
    // leftovers (fp drift): probability 1, self-alias — already initialized
    for (int32_t s : small) { prob_out[s] = 1.0f; alias_out[s] = s; }
    for (int32_t l : large) { prob_out[l] = 1.0f; alias_out[l] = l; }
}

// Batched rows: h independent alias tables over rows of a (h, w) matrix.
void mitpu_build_alias_rows(int64_t h, int64_t w, const float *wts,
                            float *prob_out, int32_t *alias_out) {
    for (int64_t r = 0; r < h; r++)
        mitpu_build_alias(w, wts + r * w, prob_out + r * w,
                          alias_out + r * w);
}

}  // extern "C"
