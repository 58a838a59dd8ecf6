// Native host-side point-cloud preprocessing (C ABI, ctypes-bound).
//
// The host data pipeline's hot loops (SURVEY §2.1):
//   * elastic_distortion: blurred displacement noise grids trilinearly
//     interpolated at the points (reference
//     augment/ElasticDistortionAug.py:11-91, a conv3d + grid_sample there;
//     the pure-numpy fallback is Python-loop bound on 100k+ point scenes),
//   * voxel_keys: linearised voxel cell keys (reference
//     custom_ops/ball_query/compute_keys.cu cell math, used host-side for
//     packing/bucketing decisions),
//   * crop_nearest: keep the max_pts nearest points around a seed point
//     (reference augment/CropPtsAug.py:8-73),
//   * select_nearest: the same selection over squared distances the caller
//     computed, refusing where the cut falls between equal distances.
//
// Built by se3conv3d_tpu_torch/native/__init__.py (g++ -O3 -march=native
// -fPIC -shared -std=c++17). No external dependencies.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <random>
#include <vector>
#include <algorithm>

extern "C" {

// Blur a [3, X, Y, Z] noise grid twice with a 3-tap box filter per axis.
static void box_blur(std::vector<float>& g, int64_t X, int64_t Y, int64_t Z) {
    std::vector<float> tmp(g.size());
    const int64_t plane = Y * Z;
    auto idx = [&](int c, int64_t x, int64_t y, int64_t z) {
        return ((int64_t)c * X + x) * plane + y * Z + z;
    };
    for (int pass = 0; pass < 2; ++pass) {
        // axis X
        for (int c = 0; c < 3; ++c)
            for (int64_t x = 0; x < X; ++x)
                for (int64_t y = 0; y < Y; ++y)
                    for (int64_t z = 0; z < Z; ++z) {
                        float s = g[idx(c, x, y, z)];
                        if (x > 0) s += g[idx(c, x - 1, y, z)];
                        if (x + 1 < X) s += g[idx(c, x + 1, y, z)];
                        tmp[idx(c, x, y, z)] = s / 3.0f;
                    }
        g.swap(tmp);
        // axis Y
        for (int c = 0; c < 3; ++c)
            for (int64_t x = 0; x < X; ++x)
                for (int64_t y = 0; y < Y; ++y)
                    for (int64_t z = 0; z < Z; ++z) {
                        float s = g[idx(c, x, y, z)];
                        if (y > 0) s += g[idx(c, x, y - 1, z)];
                        if (y + 1 < Y) s += g[idx(c, x, y + 1, z)];
                        tmp[idx(c, x, y, z)] = s / 3.0f;
                    }
        g.swap(tmp);
        // axis Z
        for (int c = 0; c < 3; ++c)
            for (int64_t x = 0; x < X; ++x)
                for (int64_t y = 0; y < Y; ++y)
                    for (int64_t z = 0; z < Z; ++z) {
                        float s = g[idx(c, x, y, z)];
                        if (z > 0) s += g[idx(c, x, y, z - 1)];
                        if (z + 1 < Z) s += g[idx(c, x, y, z + 1)];
                        tmp[idx(c, x, y, z)] = s / 3.0f;
                    }
        g.swap(tmp);
    }
}

// In-place elastic distortion of pts [n, 3] (float64, like the reference's
// double-precision coords path).
void elastic_distortion(double* pts, int64_t n,
                        const double* granularity, const double* magnitude,
                        int64_t n_levels, uint64_t seed) {
    if (n <= 0) return;
    double mn[3], mx[3];
    for (int d = 0; d < 3; ++d) { mn[d] = pts[d]; mx[d] = pts[d]; }
    for (int64_t i = 1; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            mn[d] = std::min(mn[d], pts[i * 3 + d]);
            mx[d] = std::max(mx[d], pts[i * 3 + d]);
        }
    double full[3];
    for (int d = 0; d < 3; ++d) full[d] = mx[d] - mn[d];

    std::mt19937_64 rng(seed);
    std::normal_distribution<float> normal(0.0f, 1.0f);

    for (int64_t lev = 0; lev < n_levels; ++lev) {
        const double gran = granularity[lev];
        const double mag = magnitude[lev];
        const int64_t X = (int64_t)std::floor(full[0] / gran) + 3;
        const int64_t Y = (int64_t)std::floor(full[1] / gran) + 3;
        const int64_t Z = (int64_t)std::floor(full[2] / gran) + 3;
        std::vector<float> grid((size_t)(3 * X * Y * Z));
        for (auto& v : grid) v = normal(rng);
        box_blur(grid, X, Y, Z);

        const int64_t plane = Y * Z;
        auto at = [&](int c, int64_t x, int64_t y, int64_t z) {
            return grid[((int64_t)c * X + x) * plane + y * Z + z];
        };
        const int64_t dims[3] = {X, Y, Z};
        for (int64_t i = 0; i < n; ++i) {
            double u[3], pos[3];
            int64_t lo[3], hi[3];
            double w[3];
            for (int d = 0; d < 3; ++d) {
                const double denom = std::max(mx[d] - mn[d], 1e-12);
                u[d] = (pts[i * 3 + d] - mn[d]) / denom;
                pos[d] = std::min(std::max(u[d] * (dims[d] - 1), 0.0),
                                  (double)(dims[d] - 1));
                lo[d] = (int64_t)std::floor(pos[d]);
                hi[d] = std::min(lo[d] + 1, dims[d] - 1);
                w[d] = pos[d] - (double)lo[d];
            }
            for (int c = 0; c < 3; ++c) {
                double acc = 0.0;
                for (int dx = 0; dx < 2; ++dx)
                    for (int dy = 0; dy < 2; ++dy)
                        for (int dz = 0; dz < 2; ++dz) {
                            const double wx = dx ? w[0] : 1.0 - w[0];
                            const double wy = dy ? w[1] : 1.0 - w[1];
                            const double wz = dz ? w[2] : 1.0 - w[2];
                            acc += wx * wy * wz *
                                   at(c, dx ? hi[0] : lo[0],
                                      dy ? hi[1] : lo[1],
                                      dz ? hi[2] : lo[2]);
                        }
                pts[i * 3 + c] += acc * mag;
            }
        }
    }
}

// Linearised voxel keys for pts [n, 3]; cell math of the reference's
// compute_keys kernel (grid_utils.cuh:56-93) with a 1e-6 AABB margin.
void voxel_keys(const float* pts, int64_t n, float cell, int64_t* keys) {
    if (n <= 0) return;
    float mn[3], mx[3];
    for (int d = 0; d < 3; ++d) { mn[d] = pts[d]; mx[d] = pts[d]; }
    for (int64_t i = 1; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            mn[d] = std::min(mn[d], pts[i * 3 + d]);
            mx[d] = std::max(mx[d], pts[i * 3 + d]);
        }
    int64_t nc[3];
    for (int d = 0; d < 3; ++d) {
        mn[d] -= 1e-6f;
        mx[d] += 1e-6f;
        nc[d] = (int64_t)((mx[d] - mn[d]) / cell) + 1;
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t c[3];
        for (int d = 0; d < 3; ++d) {
            int64_t v = (int64_t)std::floor((pts[i * 3 + d] - mn[d]) / cell);
            c[d] = std::min(std::max(v, (int64_t)0), nc[d] - 1);
        }
        keys[i] = (c[0] * nc[1] + c[1]) * nc[2] + c[2];
    }
}

// keep[i] = 1 for the max_pts points nearest to a random seed point
// (reference CropPtsAug semantics: nth_element over squared distances).
void crop_nearest(const float* pts, int64_t n, int64_t max_pts,
                  uint64_t seed, uint8_t* keep) {
    if (max_pts >= n) {
        std::memset(keep, 1, (size_t)n);
        return;
    }
    std::mt19937_64 rng(seed);
    const int64_t center = (int64_t)(rng() % (uint64_t)n);
    std::vector<std::pair<float, int64_t>> d2(n);
    for (int64_t i = 0; i < n; ++i) {
        float s = 0.0f;
        for (int d = 0; d < 3; ++d) {
            const float diff = pts[i * 3 + d] - pts[center * 3 + d];
            s += diff * diff;
        }
        d2[i] = {s, i};
    }
    std::nth_element(d2.begin(), d2.begin() + max_pts, d2.end());
    std::memset(keep, 0, (size_t)n);
    for (int64_t i = 0; i < max_pts; ++i) keep[d2[i].second] = 1;
}

// keep[i] = 1 for the max_pts smallest of the squared distances d2 [n].
// Returns 1, or 0 (keep unwritten) where a distance is NaN or where the
// max_pts-th smallest equals the next one: there, which points are kept
// depends on the order a sort leaves ties in, and the caller sorts.
int64_t select_nearest(const float* d2, int64_t n, int64_t max_pts, uint8_t* keep) {
    for (int64_t i = 0; i < n; ++i)
        if (std::isnan(d2[i])) return 0;
    if (max_pts >= n) {
        std::memset(keep, 1, (size_t)n);
        return 1;
    }
    std::vector<float> v(d2, d2 + n);
    std::nth_element(v.begin(), v.begin() + max_pts, v.end());
    const float cut = v[max_pts];
    const float last = *std::max_element(v.begin(), v.begin() + max_pts);
    if (!(last < cut)) return 0;
    for (int64_t i = 0; i < n; ++i) keep[i] = d2[i] < cut ? 1 : 0;
    return 1;
}

}  // extern "C"
