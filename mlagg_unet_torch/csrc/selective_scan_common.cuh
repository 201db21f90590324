// Geometry shared by the selective-scan forward (K1) and backward (K5)
// kernels. K5 recomputes h inside the same LT-step tiles whose entry states
// K1 saves, so both must agree on N, DC and LT.
#pragma once

namespace scan {

constexpr int N = 16;   // states per channel = lanes per channel group
constexpr int DC = 8;   // channels per CTA
constexpr int LT = 64;  // steps staged per tile; K1 saves h every LT steps
constexpr int THREADS = DC * N;
constexpr int LP = LT + 1;  // padded row: B/C rows of 16 states hit 16 banks

__device__ __forceinline__ float softplus_f(float x) {
    // jax.nn.softplus == logaddexp(x, 0) == max(x, 0) + log1p(exp(-|x|))
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Bounds of tile `it` in scan order: a forward scan's tile it starts at
// it * LT; a reverse scan's ends at L - it * LT (its ragged tile is the
// leftmost). Returns the first natural position and sets the length.
__device__ __forceinline__ long long tile_bounds(long long it, long long L,
                                                 int reverse, int* len) {
    if (!reverse) {
        const long long t0 = it * LT;
        *len = (int)min((long long)LT, L - t0);
        return t0;
    }
    const long long end = L - it * LT;
    const long long t0 = end > LT ? end - LT : 0;
    *len = (int)(end - t0);
    return t0;
}

}  // namespace scan
