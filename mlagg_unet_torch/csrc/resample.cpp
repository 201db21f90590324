// Fast multithreaded spline resampling for the host-side hot loops
// (preprocessing per-case resample + inference export resample).
//
// Replaces scipy.ndimage.map_coordinates in _resize() with the SAME math:
// pixel-center coordinate mapping x_src = (x_dst + 0.5) * (in/out) - 0.5,
// boundary mode 'nearest', interpolation orders 0 (nearest), 1 (linear) and
// 3 (cubic B-spline with Unser's recursive prefilter, matching
// scipy.ndimage.spline_filter). OpenMP-parallel over output voxels.
//
// From the JAX package's csrc/resample.cpp, with the same arithmetic on
// every element, so bit-equal to it, and less work for the order-3
// prefilter: the 12 edge-padded planes on each side of z are copies of the
// first and last input plane, so they are filtered along x and y once and
// copied; lines along y and z are filtered many at a time (consecutive x,
// vectorisable) instead of one gathered line after another; the mirror
// indices of the causal init are stepped, not taken modulo. For a 2D slice
// (the separate-z path's unit) that is 1 plane filtered along x and y
// instead of 25. Built by mlagg_unet_torch/native/__init__.py with the
// system compiler into mlagg_unet_torch/_build/; a build that fails raises
// there.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

inline int64_t clamp_idx(int64_t i, int64_t n) {
    if (i < 0) return 0;
    if (i >= n) return n - 1;
    return i;
}

// scipy.ndimage semantics for order-3 / mode='nearest': the input is
// edge-padded by 12 per axis, prefiltered with the MIRROR-boundary Unser
// IIR (exactly scipy.ndimage.spline_filter1d(mode='mirror')), and evaluated
// on the padded coefficient array. kEdgePad below mirrors scipy's npad=12.
constexpr int64_t kEdgePad = 12;

constexpr int kInitTerms = 40;  // causal init: truncated mirror series (|z|^40 ~ 1e-23)
const double kPole = std::sqrt(3.0) - 2.0;  // pole for cubic

// the mirror index of term k = 0, 1, ... of the causal init, stepped: 0, 1,
// ..., n - 1, n - 2, ..., 0, 1, ... (period 2n - 2)
void mirror_indices(int64_t n, int64_t idx[kInitTerms]) {
    int64_t i = 0, step = 1;
    for (int k = 0; k < kInitTerms; ++k) {
        idx[k] = i;
        if (i + step < 0 || i + step >= n) step = -step;
        i += step;
    }
}

// exact mirror-boundary cubic prefilter (scipy's spline_filter1d) of
// `count` lines at once, in place: element i of line j at
// base[i * stride + j] (stride >= count). The inner loops run over j, so
// each element sees the same operations in the same order as when its line
// is filtered alone.
void spline_filter_lines(double* base, int64_t n, int64_t stride, int64_t count) {
    if (n < 2) return;
    const double z = kPole;
    const double gain = (1.0 - z) * (1.0 - 1.0 / z);
    for (int64_t i = 0; i < n; ++i) {
        double* __restrict__ row = base + i * stride;
        for (int64_t j = 0; j < count; ++j) row[j] *= gain;
    }
    int64_t idx[kInitTerms];
    mirror_indices(n, idx);
    std::vector<double> sum((size_t)count, 0.0);
    double* __restrict__ s = sum.data();
    double zk = 1.0;
    for (int k = 0; k < kInitTerms; ++k) {
        const double* __restrict__ row = base + idx[k] * stride;
        for (int64_t j = 0; j < count; ++j) s[j] += zk * row[j];
        zk *= z;
    }
    std::memcpy(base, s, (size_t)count * sizeof(double));
    for (int64_t i = 1; i < n; ++i) {
        double* __restrict__ row = base + i * stride;
        const double* __restrict__ prev = base + (i - 1) * stride;
        for (int64_t j = 0; j < count; ++j) row[j] += z * prev[j];
    }
    {
        const double c = z / (z * z - 1.0);
        double* __restrict__ last = base + (n - 1) * stride;
        const double* __restrict__ prev = base + (n - 2) * stride;
        for (int64_t j = 0; j < count; ++j) last[j] = c * (z * prev[j] + last[j]);
    }
    for (int64_t i = n - 2; i >= 0; --i) {
        double* __restrict__ row = base + i * stride;
        const double* __restrict__ next = base + (i + 1) * stride;
        for (int64_t j = 0; j < count; ++j) row[j] = z * (next[j] - row[j]);
    }
}

constexpr int64_t kLineBlock = 32;  // lines along y filtered together

inline void cubic_weights(double t, double w[4]) {
    // B-spline basis for fractional offset t in [0,1): nodes at -1,0,1,2
    const double t2 = t * t, t3 = t2 * t;
    w[0] = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0;
    w[1] = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0;
    w[2] = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0;
    w[3] = t3 / 6.0;
}

}  // namespace

extern "C" {

// 3D resize (also covers 2D via nz == 1 on both sides).
// in:  (iz, iy, ix) C-order doubles; out: (oz, oy, ox).
// order: 0 nearest, 1 linear, 3 cubic B-spline.
int resample3d(const double* in, int64_t iz, int64_t iy, int64_t ix,
               double* out, int64_t oz, int64_t oy, int64_t ox,
               int order) {
    const double sz = (double)iz / (double)oz;
    const double sy = (double)iy / (double)oy;
    const double sx = (double)ix / (double)ox;

    std::unique_ptr<double[]> coeff;
    const double* src = in;
    // padded coefficient-grid geometry (order 3 only)
    int64_t pz = iz, py = iy, px = ix;
    int64_t off = 0;
    if (order == 3) {
        // edge-pad by 12 per axis (scipy's npad), then mirror-prefilter
        off = kEdgePad;
        pz = iz + 2 * off;
        py = iy + 2 * off;
        px = ix + 2 * off;
        coeff.reset(new double[(size_t)(pz * py * px)]);   // every element written below
        const int64_t plane = py * px;
        // the input's planes, edge-padded in y and x, filtered along x and y
#pragma omp parallel for collapse(2)
        for (int64_t zi = 0; zi < iz; ++zi)
            for (int64_t y = 0; y < py; ++y) {
                int64_t yi = clamp_idx(y - off, iy);
                double* row = &coeff[(zi + off) * plane + y * px];
                const double* irow = in + (zi * iy + yi) * ix;
                for (int64_t x = 0; x < px; ++x)
                    row[x] = irow[clamp_idx(x - off, ix)];
                spline_filter_lines(row, px, 1, 1);
            }
        const int64_t blocks = (px + kLineBlock - 1) / kLineBlock;
#pragma omp parallel for collapse(2)
        for (int64_t zi = 0; zi < iz; ++zi)
            for (int64_t b = 0; b < blocks; ++b) {
                const int64_t x0 = b * kLineBlock;
                spline_filter_lines(&coeff[(zi + off) * plane + x0], py, px,
                                    std::min(kLineBlock, px - x0));
            }
        // along z, a row of x at a time, after the padded planes' row is
        // copied from the first or last input plane's
#pragma omp parallel for
        for (int64_t y = 0; y < py; ++y) {
            for (int64_t z = 0; z < pz; ++z)
                if (z < off || z >= off + iz)
                    std::memcpy(&coeff[z * plane + y * px],
                                &coeff[(clamp_idx(z - off, iz) + off) * plane + y * px],
                                (size_t)px * sizeof(double));
            spline_filter_lines(&coeff[y * px], pz, plane, px);
        }
        src = coeff.get();

        // evaluate on the padded coefficients: each output's 64 taps summed
        // in the same order, the x weights and indices taken once per
        // column and the z and y ones once per row
        std::vector<double> wxs((size_t)(4 * ox));
        std::vector<int64_t> xis((size_t)(4 * ox));
        for (int64_t x = 0; x < ox; ++x) {
            const double cxp = sx * ((double)x + 0.5) - 0.5 + (double)off;
            const int64_t x0 = (int64_t)std::floor(cxp);
            cubic_weights(cxp - x0, &wxs[4 * x]);
            for (int dx = 0; dx < 4; ++dx) xis[4 * x + dx] = clamp_idx(x0 - 1 + dx, px);
        }
#pragma omp parallel for collapse(2)
        for (int64_t z = 0; z < oz; ++z)
            for (int64_t y = 0; y < oy; ++y) {
                const double czp = sz * ((double)z + 0.5) - 0.5 + (double)off;
                const double cyp = sy * ((double)y + 0.5) - 0.5 + (double)off;
                const int64_t z0 = (int64_t)std::floor(czp);
                const int64_t y0 = (int64_t)std::floor(cyp);
                double wz[4], wy[4], wzy[16];
                const double* srows[16];
                cubic_weights(czp - z0, wz);
                cubic_weights(cyp - y0, wy);
                for (int dz = 0; dz < 4; ++dz)
                    for (int dy = 0; dy < 4; ++dy) {
                        wzy[4 * dz + dy] = wz[dz] * wy[dy];
                        srows[4 * dz + dy] = src + (clamp_idx(z0 - 1 + dz, pz) * py
                                                    + clamp_idx(y0 - 1 + dy, py)) * px;
                    }
                double* orow = out + (z * oy + y) * ox;
                for (int64_t x = 0; x < ox; ++x) {
                    const double* wx = &wxs[4 * x];
                    const int64_t* xi = &xis[4 * x];
                    double acc = 0.0;
                    for (int t = 0; t < 16; ++t) {
                        const double* srow = srows[t];
                        double partial = 0.0;
                        for (int dx = 0; dx < 4; ++dx) partial += wx[dx] * srow[xi[dx]];
                        acc += wzy[t] * partial;
                    }
                    orow[x] = acc;
                }
            }
        return 0;
    }

    // orders 0 and 1
#pragma omp parallel for collapse(2)
    for (int64_t z = 0; z < oz; ++z) {
        for (int64_t y = 0; y < oy; ++y) {
            const double cz = sz * ((double)z + 0.5) - 0.5;
            const double cy = sy * ((double)y + 0.5) - 0.5;
            double* orow = out + (z * oy + y) * ox;
            for (int64_t x = 0; x < ox; ++x) {
                const double cx = sx * ((double)x + 0.5) - 0.5;
                if (order == 0) {
                    int64_t pz = clamp_idx((int64_t)std::llround(cz), iz);
                    int64_t py = clamp_idx((int64_t)std::llround(cy), iy);
                    int64_t px = clamp_idx((int64_t)std::llround(cx), ix);
                    orow[x] = src[(pz * iy + py) * ix + px];
                } else if (order == 1) {
                    int64_t z0 = (int64_t)std::floor(cz);
                    int64_t y0 = (int64_t)std::floor(cy);
                    int64_t x0 = (int64_t)std::floor(cx);
                    double tz = cz - z0, ty = cy - y0, tx = cx - x0;
                    double acc = 0.0;
                    for (int dz = 0; dz < 2; ++dz) {
                        int64_t pz = clamp_idx(z0 + dz, iz);
                        double wz = dz ? tz : 1.0 - tz;
                        if (iz == 1) { pz = 0; wz = dz ? 0.0 : 1.0; }
                        for (int dy = 0; dy < 2; ++dy) {
                            int64_t py = clamp_idx(y0 + dy, iy);
                            double wy = dy ? ty : 1.0 - ty;
                            if (iy == 1) { py = 0; wy = dy ? 0.0 : 1.0; }
                            for (int dx = 0; dx < 2; ++dx) {
                                int64_t px = clamp_idx(x0 + dx, ix);
                                double wx = dx ? tx : 1.0 - tx;
                                if (ix == 1) { px = 0; wx = dx ? 0.0 : 1.0; }
                                acc += wz * wy * wx *
                                       src[(pz * iy + py) * ix + px];
                            }
                        }
                    }
                    orow[x] = acc;
                }
            }
        }
    }
    return 0;
}

}  // extern "C"
