// Native host kernels for gridpp_tpu's parity (numpy) API.
//
// The parity API executes on the host; most operators compile well under
// XLA:CPU, but three are dominated by per-cell work XLA vectorizes badly
// (windowed sorts, binary searches, scan-order-dependent fallbacks).
// These get hand-written threaded C++ kernels:
//   - nb_brute:            brute-force windowed statistics/quantiles
//                          (reference src/api/neighbourhood.cpp:556-654)
//   - apply_curve_1d/
//     apply_curve_percell: calibration-curve application
//                          (reference src/api/curve.cpp:6-133)
//   - nb_search:           conditional neighbourhood mean
//                          (reference src/api/neighbourhood_search.cpp)
//
// Semantics mirror the package's jitted device ops exactly (see
// ops/neighbourhood.py, ops/curves.py, ops/search.py); host-vs-device
// parity is tested in tests/test_host_device_parity.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

const float kNaN = std::numeric_limits<float>::quiet_NaN();

inline bool valid(float v) { return std::isfinite(v); }

void parallel_rows(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    unsigned nt = std::max(1u, std::thread::hardware_concurrency());
    if (n < 64 || nt == 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (unsigned t = 0; t < nt; t++) {
        int64_t s = t * chunk;
        int64_t e = std::min<int64_t>(n, s + chunk);
        if (s >= e) break;
        threads.emplace_back(fn, s, e);
    }
    for (auto& th : threads) th.join();
}

// gridpp Statistic enum values (constants.py / gridpp.h:89-101)
enum Stat {
    kMean = 0, kMin = 10, kMedian = 20, kMax = 30, kQuantile = 40,
    kStd = 50, kVariance = 60, kSum = 70, kCount = 80
};

// K-shift population variance (reference util.cpp:38-73): shift by the
// first valid element, E[Y^2]-E[Y]^2, clamped at 0.
inline float variance_kshift(const float* v, int64_t n) {
    if (n <= 0) return kNaN;
    double k = v[0];
    double s = 0, s2 = 0;
    for (int64_t i = 0; i < n; i++) {
        double y = (double)v[i] - k;
        s += y;
        s2 += y * y;
    }
    double mean = s / (double)n;
    double var = s2 / (double)n - mean * mean;
    return (float)std::max(var, 0.0);
}

inline float stat_of(float* buf, int64_t n, int stat, double q) {
    switch (stat) {
        case kMean: case kSum: case kCount: {
            double s = 0;
            for (int64_t i = 0; i < n; i++) s += buf[i];
            if (stat == kCount) return (float)n;
            if (n == 0) return kNaN;
            return stat == kMean ? (float)(s / (double)n) : (float)s;
        }
        case kMin: {
            if (n == 0) return kNaN;
            return *std::min_element(buf, buf + n);
        }
        case kMax: {
            if (n == 0) return kNaN;
            return *std::max_element(buf, buf + n);
        }
        case kMedian: case kQuantile: {
            if (n == 0) return kNaN;
            // Only the lo-th and (lo+1)-th order statistics are needed:
            // nth_element (O(n)) beats the full sort ~2-3x at window sizes
            double qq = stat == kMedian ? 0.5 : q;
            double qn = qq * (double)(n - 1);
            int64_t lo = (int64_t)std::floor(qn);
            int64_t hi = (int64_t)std::ceil(qn);
            lo = std::min(std::max<int64_t>(lo, 0), n - 1);
            hi = std::min(std::max<int64_t>(hi, 0), n - 1);
            std::nth_element(buf, buf + lo, buf + n);
            float lv = buf[lo];
            float uv = lv;
            if (hi > lo)
                uv = *std::min_element(buf + lo + 1, buf + n);
            double denom = (double)(hi - lo);
            double f = denom > 0 ? (qn - (double)lo) / denom : 0.0;
            return (float)(lv + (uv - lv) * f);
        }
        case kStd: case kVariance: {
            float var = variance_kshift(buf, n);
            return stat == kStd ? std::sqrt(var) : var;
        }
    }
    return kNaN;
}

}  // namespace

extern "C" {

// Brute-force windowed statistic over a (ny, nx, ne) field (ne=1 for 2-D),
// halfwidth h. Window scan order matches the reference's loops
// (neighbourhood.cpp:566-602): rows, columns, then ensemble members -
// this order defines the K shift for Std/Variance.
void nb_brute(const float* in, int64_t ny, int64_t nx, int64_t ne, int stat,
              double quantile, int64_t h, float* out) {
    const size_t wy = (size_t)std::min(2 * h + 1, ny);
    const size_t wx = (size_t)std::min(2 * h + 1, nx);
    parallel_rows(ny, [&](int64_t y0, int64_t y1) {
        std::vector<float> buf;
        buf.reserve(wy * wx * (size_t)ne);
        for (int64_t y = y0; y < y1; y++) {
            int64_t ys = std::max<int64_t>(0, y - h);
            int64_t ye = std::min<int64_t>(ny - 1, y + h);
            for (int64_t x = 0; x < nx; x++) {
                int64_t xs = std::max<int64_t>(0, x - h);
                int64_t xe = std::min<int64_t>(nx - 1, x + h);
                buf.clear();
                for (int64_t yy = ys; yy <= ye; yy++) {
                    const float* row = in + (yy * nx + xs) * ne;
                    for (int64_t c = 0; c < (xe - xs + 1) * ne; c++) {
                        float v = row[c];
                        if (valid(v)) buf.push_back(v);
                    }
                }
                out[y * nx + x] =
                    stat_of(buf.data(), (int64_t)buf.size(), stat, quantile);
            }
        }
    });
}

// Per-cell quantile levels variant (quantile may be a (ny, nx) field,
// gridpp.h:1480). NaN level -> NaN output.
void nb_brute_quantile_field(const float* in, int64_t ny, int64_t nx,
                             int64_t ne, const float* qfield, int64_t h,
                             float* out) {
    const size_t wy = (size_t)std::min(2 * h + 1, ny);
    const size_t wx = (size_t)std::min(2 * h + 1, nx);
    parallel_rows(ny, [&](int64_t y0, int64_t y1) {
        std::vector<float> buf;
        buf.reserve(wy * wx * (size_t)ne);
        for (int64_t y = y0; y < y1; y++) {
            int64_t ys = std::max<int64_t>(0, y - h);
            int64_t ye = std::min<int64_t>(ny - 1, y + h);
            for (int64_t x = 0; x < nx; x++) {
                float q = qfield[y * nx + x];
                if (!valid(q)) {
                    out[y * nx + x] = kNaN;
                    continue;
                }
                int64_t xs = std::max<int64_t>(0, x - h);
                int64_t xe = std::min<int64_t>(nx - 1, x + h);
                buf.clear();
                for (int64_t yy = ys; yy <= ye; yy++) {
                    const float* row = in + (yy * nx + xs) * ne;
                    for (int64_t c = 0; c < (xe - xs + 1) * ne; c++) {
                        float v = row[c];
                        if (valid(v)) buf.push_back(v);
                    }
                }
                out[y * nx + x] = stat_of(buf.data(), (int64_t)buf.size(),
                                          kQuantile, (double)q);
            }
        }
    });
}

namespace {

// gridpp interpolate (util.cpp:377-432) on one value against a sorted
// curve of length c (flat-interval averaging rules included).
inline float interp_curve(float x, const float* xp, const float* yp,
                          int64_t c) {
    if (!std::isfinite(x)) return kNaN;
    if (x > xp[c - 1]) return yp[c - 1];
    if (x < xp[0]) return yp[0];
    const float* lb = std::lower_bound(xp, xp + c, x);   // first >= x
    const float* ub = std::upper_bound(xp, xp + c, x);   // first > x
    int64_t left = lb - xp;
    int64_t right = ub - xp;
    bool has_exact = right > left;
    int64_t i0 = has_exact ? left : left - 1;
    int64_t i1 = has_exact ? right - 1 : right;
    int64_t i0c = std::min(std::max<int64_t>(i0, 0), c - 1);
    int64_t i1c = std::min(std::max<int64_t>(i1, 0), c - 1);
    float x0 = xp[i0c], x1 = xp[i1c];
    float y0 = yp[i0c], y1 = yp[i1c];
    if (x0 == x1) {
        if (i0 == 0 && i1 == c - 1) return (y0 + y1) / 2;
        if (i0 == 0) return y1;
        if (i1 == c - 1) return y0;
        return (y0 + y1) / 2;
    }
    return y0 + (y1 - y0) * (x - x0) / (x1 - x0);
}

// gridpp Extrapolation enum values (constants.py / gridpp.h:79-86)
enum Policy {
    kOneToOne = 0, kMeanSlope = 10, kNearestSlope = 20, kZero = 30,
    kUnchanged = 40
};

inline float extrapolate(float x, int policy, int64_t c, float nearest_r,
                         float nearest_f, float d_r, float d_f, float lo_r,
                         float hi_r, float lo_f, float hi_f) {
    if (policy == kUnchanged) return x;
    float slope;
    if (policy == kZero) slope = 0.0f;
    else if (policy == kOneToOne || c <= 1) slope = 1.0f;
    else if (policy == kMeanSlope) slope = (hi_r - lo_r) / (hi_f - lo_f);
    else slope = d_r / d_f;  // kNearestSlope
    return nearest_r + slope * (x - nearest_f);
}

inline float apply_one(float x, const float* cr, const float* cf, int64_t c,
                       int pb, int pa) {
    if (!std::isfinite(x)) return kNaN;
    float lo_f = cf[0], hi_f = cf[c - 1];
    float lo_r = cr[0], hi_r = cr[c - 1];
    float bdr = 1, bdf = 1, adr = 1, adf = 1;
    if (c >= 2) {
        bdr = cr[1] - cr[0];
        bdf = cf[1] - cf[0];
        adr = cr[c - 1] - cr[c - 2];
        adf = cf[c - 1] - cf[c - 2];
    }
    if (x < lo_f)
        return extrapolate(x, pb, c, lo_r, lo_f, bdr, bdf, lo_r, hi_r, lo_f,
                           hi_f);
    if (x > hi_f)
        return extrapolate(x, pa, c, hi_r, hi_f, adr, adf, lo_r, hi_r, lo_f,
                           hi_f);
    return interp_curve(x, cf, cr, c);
}

}  // namespace

// apply_curve with one shared curve (curve.cpp:6-103).
//
// The searches use a bucketized index over the sorted curve x-axis:
// table[b] = first curve index at or past bucket b's left edge, so each
// value needs one multiply plus a short local scan instead of two
// binary searches (that alone is ~7x on a 2000-point curve).
void apply_curve_1d(const float* fcst, int64_t n, const float* curve_ref,
                    const float* curve_fcst, int64_t c, int pb, int pa,
                    float* out) {
    const float* cf = curve_fcst;
    const float* cr = curve_ref;
    const float lo = cf[0], hi = cf[c - 1];
    const int64_t nb = std::min<int64_t>(4 * c, 1 << 16);
    const double invw = (hi > lo) ? (double)nb / ((double)hi - (double)lo)
                                  : 0.0;
    std::vector<int32_t> table;
    if (invw > 0) {
        table.resize(nb + 1);
        int64_t i = 0;
        for (int64_t b = 0; b <= nb; b++) {
            double edge = (double)lo + (double)b / invw;
            while (i < c && (double)cf[i] < edge) i++;
            table[b] = (int32_t)i;
        }
    }
    parallel_rows(n, [&](int64_t s, int64_t e) {
        for (int64_t j = s; j < e; j++) {
            float x = fcst[j];
            if (!std::isfinite(x) || x < lo || x > hi || invw <= 0) {
                out[j] = apply_one(x, cr, cf, c, pb, pa);
                continue;
            }
            int64_t b = (int64_t)(((double)x - (double)lo) * invw);
            b = std::min(std::max<int64_t>(b, 0), nb);
            int64_t left = table[b];
            while (left > 0 && cf[left - 1] >= x) left--;
            while (left < c && cf[left] < x) left++;
            int64_t right = left;
            while (right < c && cf[right] <= x) right++;
            // interp_curve's body with the bounds precomputed
            bool has_exact = right > left;
            int64_t i0 = has_exact ? left : left - 1;
            int64_t i1 = has_exact ? right - 1 : right;
            int64_t i0c = std::min(std::max<int64_t>(i0, 0), c - 1);
            int64_t i1c = std::min(std::max<int64_t>(i1, 0), c - 1);
            float x0 = cf[i0c], x1 = cf[i1c];
            float y0 = cr[i0c], y1 = cr[i1c];
            if (x0 == x1) {
                if (i0 == 0 && i1 == c - 1) out[j] = (y0 + y1) / 2;
                else if (i0 == 0) out[j] = y1;
                else if (i1 == c - 1) out[j] = y0;
                else out[j] = (y0 + y1) / 2;
            } else {
                out[j] = y0 + (y1 - y0) * (x - x0) / (x1 - x0);
            }
        }
    });
}

// apply_curve with per-cell curves, cell-major (curve.cpp:105-133).
void apply_curve_percell(const float* fcst, int64_t n, const float* curve_ref,
                         const float* curve_fcst, int64_t c, int pb, int pa,
                         float* out) {
    parallel_rows(n, [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++)
            out[i] = apply_one(fcst[i], curve_ref + i * c, curve_fcst + i * c,
                               c, pb, pa);
    });
}

// Conditional neighbourhood mean with the reference's scan-order fallback
// (neighbourhood_search.cpp:7-113; see ops/search.py for the rules).
void nb_search(const float* arr, const float* search, int64_t ny, int64_t nx,
               int64_t h, float tmin, float tmax, float delta,
               const float* apply, int use_apply, float* out) {
    parallel_rows(ny, [&](int64_t y0, int64_t y1) {
        for (int64_t y = y0; y < y1; y++) {
            int64_t ys = std::max<int64_t>(0, y - h);
            int64_t ye = std::min<int64_t>(ny - 1, y + h);
            for (int64_t x = 0; x < nx; x++) {
                float center = search[y * nx + x];
                float self = arr[y * nx + x];
                if (!valid(center) || (use_apply && apply[y * nx + x] != 1)) {
                    out[y * nx + x] = self;
                    continue;
                }
                int64_t xs = std::max<int64_t>(0, x - h);
                int64_t xe = std::min<int64_t>(nx - 1, x + h);
                int64_t counter = 0;
                double sum = 0;
                double best = std::numeric_limits<double>::infinity();
                float best_val = kNaN;
                bool has_fb = false;
                for (int64_t yy = ys; yy <= ye; yy++) {
                    const float* srow = search + yy * nx;
                    const float* arow = arr + yy * nx;
                    for (int64_t xx = xs; xx <= xe; xx++) {
                        float sv = srow[xx];
                        float av = arow[xx];
                        if (!valid(sv) || !valid(av)) continue;
                        if (sv >= tmin && sv <= tmax) {
                            counter++;
                            sum += av;
                        } else if (counter > 0) {
                            continue;
                        } else if (std::fabs(sv - center) >= delta) {
                            double d = std::min(std::fabs(sv - tmin),
                                                std::fabs(sv - tmax));
                            if (d < best) {
                                best = d;
                                best_val = av;
                                has_fb = true;
                            }
                        }
                    }
                }
                out[y * nx + x] = counter > 0 ? (float)(sum / (double)counter)
                                  : (has_fb ? best_val : self);
            }
        }
    });
}

// Separable running-sum neighbourhood Mean/Sum/Count/Std/Variance over a
// (ny, nx) field with halfwidth h (reference src/api/neighbourhood.cpp:
// 45-144 uses a double summed-area table; this is the streaming
// equivalent with a ring buffer of windowed row sums - O(1)/cell, no
// O(N) f64 table in memory). NaN = missing: skipped in sums and counts.
// Threads split the column range; each column slice runs the full
// y-sweep independently (the row windows read input beyond the slice).
void nb_meansum(const float* in, int64_t ny, int64_t nx, int64_t h_,
                int stat, float* out) {
    // Halfwidths beyond the grid extent are equivalent after edge
    // clipping; clamping bounds the ring buffer
    const int64_t h = std::min(std::max<int64_t>(0, h_),
                               std::max(ny, nx) - 1);
    const bool need2 = (stat == kStd || stat == kVariance);
    unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
    if (nx < 256) nthreads = 1;
    std::vector<std::thread> threads;
    int64_t chunk = (nx + nthreads - 1) / nthreads;

    auto run_slice = [&](int64_t x0, int64_t x1) {
        const int64_t w = x1 - x0;
        const int64_t ring = 2 * h + 2;
        std::vector<double> rs(ring * w), rs2(need2 ? ring * w : 0);
        std::vector<int32_t> rc(ring * w);
        std::vector<double> acc(w, 0.0), acc2(need2 ? w : 0, 0.0);
        std::vector<int64_t> accc(w, 0);

        auto compute_row = [&](int64_t yy) {
            double* prs = rs.data() + (yy % ring) * w;
            double* prs2 = need2 ? rs2.data() + (yy % ring) * w : nullptr;
            int32_t* prc = rc.data() + (yy % ring) * w;
            const float* row = in + yy * nx;
            double s = 0, s2 = 0;
            int32_t c = 0;
            for (int64_t xx = std::max<int64_t>(0, x0 - h);
                 xx <= std::min<int64_t>(nx - 1, x0 + h); xx++) {
                float v = row[xx];
                if (valid(v)) {
                    s += v;
                    if (need2) s2 += (double)(v * v);  // f32 square, like
                    c++;                               // the reference
                }
            }
            for (int64_t x = x0; x < x1; x++) {
                if (x > x0) {
                    int64_t addx = x + h;
                    if (addx < nx) {
                        float v = row[addx];
                        if (valid(v)) {
                            s += v;
                            if (need2) s2 += (double)(v * v);
                            c++;
                        }
                    }
                    int64_t remx = x - h - 1;
                    if (remx >= 0) {
                        float v = row[remx];
                        if (valid(v)) {
                            s -= v;
                            if (need2) s2 -= (double)(v * v);
                            c--;
                        }
                    }
                }
                prs[x - x0] = s;
                if (need2) prs2[x - x0] = s2;
                prc[x - x0] = c;
            }
        };

        int64_t next_row = 0;
        for (int64_t y = 0; y < ny; y++) {
            int64_t top = std::min<int64_t>(y + h, ny - 1);
            while (next_row <= top) {
                compute_row(next_row);
                const double* prs = rs.data() + (next_row % ring) * w;
                const double* prs2 = need2
                    ? rs2.data() + (next_row % ring) * w : nullptr;
                const int32_t* prc = rc.data() + (next_row % ring) * w;
                for (int64_t i = 0; i < w; i++) {
                    acc[i] += prs[i];
                    if (need2) acc2[i] += prs2[i];
                    accc[i] += prc[i];
                }
                next_row++;
            }
            int64_t bot = y - h - 1;
            if (bot >= 0) {
                const double* prs = rs.data() + (bot % ring) * w;
                const double* prs2 = need2
                    ? rs2.data() + (bot % ring) * w : nullptr;
                const int32_t* prc = rc.data() + (bot % ring) * w;
                for (int64_t i = 0; i < w; i++) {
                    acc[i] -= prs[i];
                    if (need2) acc2[i] -= prs2[i];
                    accc[i] -= prc[i];
                }
            }
            float* orow = out + y * nx + x0;
            for (int64_t i = 0; i < w; i++) {
                int64_t c = accc[i];
                if (stat == kCount) {
                    orow[i] = (float)c;
                } else if (c <= 0) {
                    orow[i] = kNaN;
                } else if (stat == kSum) {
                    orow[i] = (float)acc[i];
                } else if (stat == kMean) {
                    orow[i] = (float)(acc[i] / (double)c);
                } else {
                    // Std/Variance via two f32 mean fields subtracted in
                    // f32, reproducing the reference's arithmetic exactly
                    // (neighbourhood.cpp:211-235: double SAT -> float
                    // mean fields -> float mean2 - mean*mean, unclamped)
                    float mean = (float)(acc[i] / (double)c);
                    float mean2 = (float)(acc2[i] / (double)c);
                    float var = mean2 - mean * mean;
                    orow[i] = stat == kStd ? std::sqrt(var) : var;
                }
            }
        }
    };

    for (unsigned t = 0; t < nthreads; t++) {
        int64_t s = t * chunk;
        int64_t e = std::min<int64_t>(nx, s + chunk);
        if (s >= e) break;
        threads.emplace_back(run_slice, s, e);
    }
    for (auto& th : threads) th.join();
}

// 1-D running-window Mean/Sum/Count along rows of a (ncase, nt) array
// (reference src/api/window.cpp:6-156; semantics mirror ops/window.py:
// `before` trailing windows, keep_missing, missing_edges flags).
void window_run(const float* in, int64_t ncase, int64_t nt, int64_t length,
                int stat, int before, int keep_missing, int missing_edges,
                float* out) {
    parallel_rows(ncase, [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; r++) {
            const float* row = in + r * nt;
            float* orow = out + r * nt;
            double wsum = 0;
            int64_t wcnt = 0;
            int64_t lo = 0, hi = -1;  // current inclusive window [lo, hi]
            for (int64_t x = 0; x < nt; x++) {
                int64_t start, end;
                if (before) {
                    start = std::max<int64_t>(0, x - length + 1);
                    end = x;
                } else {
                    start = std::max<int64_t>(0, x - length / 2);
                    end = std::min<int64_t>(nt - 1, x + length / 2);
                }
                while (hi < end) {
                    hi++;
                    float v = row[hi];
                    if (valid(v)) { wsum += v; wcnt++; }
                }
                while (lo < start) {
                    float v = row[lo];
                    if (valid(v)) { wsum -= v; wcnt--; }
                    lo++;
                }
                float o;
                if (stat == kCount) {
                    o = (float)wcnt;
                } else if (wcnt != 0) {
                    o = stat == kMean ? (float)(wsum / (double)wcnt)
                                      : (float)wsum;
                } else {
                    o = kNaN;
                }
                if (stat != kCount) {
                    if (keep_missing && wcnt < end - start + 1) o = kNaN;
                    bool edge = before
                        ? (x < length - 1)
                        : (x < length / 2 || x + length / 2 + 1 > nt);
                    if (missing_edges && edge) o = kNaN;
                }
                orow[x] = o;
            }
        }
    });
}

// doping_square (reference src/api/doping.cpp:5-48): write each
// observation over a clipped square footprint around its nearest cell,
// optionally gated by elevation difference. Sequential by construction:
// later points overwrite earlier ones.
void doping_square(const int64_t* cy, const int64_t* cx, const float* obs,
                   const int64_t* hw, const float* pelev, const float* gelev,
                   int64_t np_, int64_t ny, int64_t nx, int check_elev,
                   float max_diff, float* out) {
    for (int64_t i = 0; i < np_; i++) {
        int64_t y0 = std::max<int64_t>(0, cy[i] - hw[i]);
        int64_t y1 = std::min<int64_t>(ny - 1, cy[i] + hw[i]);
        int64_t x0 = std::max<int64_t>(0, cx[i] - hw[i]);
        int64_t x1 = std::min<int64_t>(nx - 1, cx[i] + hw[i]);
        float v = obs[i];
        float pe = pelev[i];
        for (int64_t y = y0; y <= y1; y++) {
            float* orow = out + y * nx;
            const float* erow = gelev + y * nx;
            if (check_elev) {
                for (int64_t x = x0; x <= x1; x++)
                    if (std::fabs(pe - erow[x]) <= max_diff) orow[x] = v;
            } else {
                for (int64_t x = x0; x <= x1; x++) orow[x] = v;
            }
        }
    }
}

// Fused threshold-CDF windowed quantile (reference src/api/
// neighbourhood.cpp:296-527 neighbourhood_quantile_fast): the reference
// runs one Mean filter per threshold then interpolates the quantile
// across the T CDF fields. This kernel streams ALL T indicator sums and
// the valid count in ONE ring-buffer pass (indicator sums are exact
// integers, so int accumulators reproduce the double-SAT arithmetic
// bit-for-bit), then does the inverse-CDF interpolation inline per cell
// with gridpp::interpolate's flat-interval rules and the exact-edge
// special cases (neighbourhood.cpp:385-401). qfield (nullable)
// overrides the scalar quantile per cell.
void nb_quantile_fast(const float* in, int64_t ny, int64_t nx, int64_t h_,
                      const float* thresholds, int64_t t,
                      const float* qfield, float q_scalar, float* out) {
    const int64_t h = std::min(std::max<int64_t>(0, h_),
                               std::max(ny, nx) - 1);
    const float nanf = std::numeric_limits<float>::quiet_NaN();
    unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
    if (nx < 256) nthreads = 1;
    std::vector<std::thread> threads;
    int64_t chunk = (nx + nthreads - 1) / nthreads;

    auto run_slice = [&](int64_t x0, int64_t x1) {
        const int64_t w = x1 - x0;
        const int64_t ring = 2 * h + 2;
        std::vector<int32_t> rs(ring * w * t), rc(ring * w);
        std::vector<int64_t> acc(w * t, 0), accc(w, 0);
        std::vector<float> cdf(t);

        auto compute_row = [&](int64_t yy) {
            int32_t* ps = rs.data() + (yy % ring) * w * t;
            int32_t* pc = rc.data() + (yy % ring) * w;
            const float* row = in + yy * nx;
            std::vector<int32_t> s(t, 0);
            int32_t c = 0;
            auto addcell = [&](int64_t xx, int32_t sign) {
                float v = row[xx];
                if (valid(v)) {
                    c += sign;
                    for (int64_t k = 0; k < t; k++)
                        s[k] += sign * (int32_t)(v <= thresholds[k]);
                }
            };
            for (int64_t xx = std::max<int64_t>(0, x0 - h);
                 xx <= std::min<int64_t>(nx - 1, x0 + h); xx++)
                addcell(xx, 1);
            for (int64_t x = x0; x < x1; x++) {
                if (x > x0) {
                    if (x + h < nx) addcell(x + h, 1);
                    if (x - h - 1 >= 0) addcell(x - h - 1, -1);
                }
                pc[x - x0] = c;
                for (int64_t k = 0; k < t; k++)
                    ps[(x - x0) * t + k] = s[k];
            }
        };

        int64_t next_row = 0;
        for (int64_t y = 0; y < ny; y++) {
            int64_t top = std::min<int64_t>(y + h, ny - 1);
            while (next_row <= top) {
                compute_row(next_row);
                const int32_t* ps = rs.data() + (next_row % ring) * w * t;
                const int32_t* pc = rc.data() + (next_row % ring) * w;
                for (int64_t i = 0; i < w; i++) {
                    accc[i] += pc[i];
                    for (int64_t k = 0; k < t; k++)
                        acc[i * t + k] += ps[i * t + k];
                }
                next_row++;
            }
            int64_t bot = y - h - 1;
            if (bot >= 0) {
                const int32_t* ps = rs.data() + (bot % ring) * w * t;
                const int32_t* pc = rc.data() + (bot % ring) * w;
                for (int64_t i = 0; i < w; i++) {
                    accc[i] -= pc[i];
                    for (int64_t k = 0; k < t; k++)
                        acc[i * t + k] -= ps[i * t + k];
                }
            }
            float* orow = out + y * nx + x0;
            const float* qrow = qfield ? qfield + y * nx + x0 : nullptr;
            for (int64_t i = 0; i < w; i++) {
                float q = qrow ? qrow[i] : q_scalar;
                int64_t c = accc[i];
                if (c <= 0 || !std::isfinite(q)) {
                    orow[i] = nanf;
                    continue;
                }
                for (int64_t k = 0; k < t; k++) {
                    float v = (float)((double)acc[i * t + k] / (double)c);
                    cdf[k] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
                }
                // inverse CDF (ops/neighbourhood._interp_quantile_tyx)
                int64_t left = 0, right = 0;
                for (int64_t k = 0; k < t; k++) {
                    left += (int64_t)(cdf[k] < q);
                    right += (int64_t)(cdf[k] <= q);
                }
                bool has_exact = right > left;
                int64_t i0 = has_exact ? left : left - 1;
                int64_t i1 = has_exact ? right - 1 : right;
                int64_t i0c = std::min(std::max<int64_t>(i0, 0), t - 1);
                int64_t i1c = std::min(std::max<int64_t>(i1, 0), t - 1);
                float xx0 = cdf[i0c], xx1 = cdf[i1c];
                float yy0 = thresholds[i0c], yy1 = thresholds[i1c];
                bool flat = xx0 == xx1;
                float y_out;
                if (flat) {
                    if (i0 == 0 && i1 == t - 1)
                        y_out = (yy0 + yy1) * 0.5f;
                    else if (i0 == 0)
                        y_out = yy1;
                    else if (i1 == t - 1)
                        y_out = yy0;
                    else
                        y_out = (yy0 + yy1) * 0.5f;
                } else {
                    y_out = yy0 + (yy1 - yy0) * (q - xx0) / (xx1 - xx0);
                }
                if (q > cdf[t - 1]) y_out = thresholds[t - 1];
                if (q < cdf[0]) y_out = thresholds[0];
                if (q == 1.0f && cdf[0] == 1.0f) y_out = thresholds[0];
                if (q == 0.0f && cdf[t - 1] == 0.0f)
                    y_out = thresholds[t - 1];
                orow[i] = y_out;
            }
        }
    };

    for (unsigned th = 0; th < nthreads; th++) {
        int64_t s = th * chunk;
        int64_t e = std::min<int64_t>(nx, s + chunk);
        if (s >= e) break;
        threads.emplace_back(run_slice, s, e);
    }
    for (auto& th : threads) th.join();
}

// Fused linear-regression gradient (reference src/api/calc_gradient.cpp:
// 76-124): the reference computes five separate neighbourhood Mean/Sum
// filters (x, y, x*x, x*y, valid-count) and combines them per cell. This
// kernel streams all five windowed moments in ONE pass over memory with
// the nb_meansum ring-buffer scheme, then forms
//   grad = (mean_xy - mean_x*mean_y) / (mean_xx - mean_x^2)
// in f32 (mean fields cast to f32 first, like the reference's float
// neighbourhood outputs). A cell is valid only where BOTH base and
// values are finite. min_range gates on sqrt(var) when use_min_range.
void calc_gradient_lr(const float* base, const float* values, int64_t ny,
                      int64_t nx, int64_t h_, int64_t min_num,
                      float min_range, int use_min_range,
                      float default_gradient, float* out) {
    const int64_t h = std::min(std::max<int64_t>(0, h_),
                               std::max(ny, nx) - 1);
    unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
    if (nx < 256) nthreads = 1;
    std::vector<std::thread> threads;
    int64_t chunk = (nx + nthreads - 1) / nthreads;

    auto run_slice = [&](int64_t x0, int64_t x1) {
        const int64_t w = x1 - x0;
        const int64_t ring = 2 * h + 2;
        // per-row windowed sums: x, y, xx, xy + count
        std::vector<double> rx(ring * w), ry(ring * w), rxx(ring * w),
            rxy(ring * w);
        std::vector<int32_t> rc(ring * w);
        std::vector<double> ax(w, 0.0), ay(w, 0.0), axx(w, 0.0),
            axy(w, 0.0);
        std::vector<int64_t> ac(w, 0);

        auto compute_row = [&](int64_t yy) {
            const int64_t o = (yy % ring) * w;
            double* px = rx.data() + o;
            double* py = ry.data() + o;
            double* pxx = rxx.data() + o;
            double* pxy = rxy.data() + o;
            int32_t* pc = rc.data() + o;
            const float* brow = base + yy * nx;
            const float* vrow = values + yy * nx;
            double sx = 0, sy = 0, sxx = 0, sxy = 0;
            int32_t c = 0;
            auto addcell = [&](int64_t xx, double sign) {
                float b = brow[xx], v = vrow[xx];
                if (valid(b) && valid(v)) {
                    sx += sign * b;
                    sy += sign * v;
                    sxx += sign * (double)(b * b);  // f32 products, like
                    sxy += sign * (double)(b * v);  // the reference
                    c += (int32_t)sign;
                }
            };
            for (int64_t xx = std::max<int64_t>(0, x0 - h);
                 xx <= std::min<int64_t>(nx - 1, x0 + h); xx++)
                addcell(xx, 1.0);
            for (int64_t x = x0; x < x1; x++) {
                if (x > x0) {
                    if (x + h < nx) addcell(x + h, 1.0);
                    if (x - h - 1 >= 0) addcell(x - h - 1, -1.0);
                }
                px[x - x0] = sx;
                py[x - x0] = sy;
                pxx[x - x0] = sxx;
                pxy[x - x0] = sxy;
                pc[x - x0] = c;
            }
        };

        int64_t next_row = 0;
        for (int64_t y = 0; y < ny; y++) {
            int64_t top = std::min<int64_t>(y + h, ny - 1);
            while (next_row <= top) {
                compute_row(next_row);
                const int64_t o = (next_row % ring) * w;
                for (int64_t i = 0; i < w; i++) {
                    ax[i] += rx[o + i];
                    ay[i] += ry[o + i];
                    axx[i] += rxx[o + i];
                    axy[i] += rxy[o + i];
                    ac[i] += rc[o + i];
                }
                next_row++;
            }
            int64_t bot = y - h - 1;
            if (bot >= 0) {
                const int64_t o = (bot % ring) * w;
                for (int64_t i = 0; i < w; i++) {
                    ax[i] -= rx[o + i];
                    ay[i] -= ry[o + i];
                    axx[i] -= rxx[o + i];
                    axy[i] -= rxy[o + i];
                    ac[i] -= rc[o + i];
                }
            }
            float* orow = out + y * nx + x0;
            for (int64_t i = 0; i < w; i++) {
                int64_t c = ac[i];
                float g = default_gradient;
                if (c > 0 && c >= min_num) {
                    float mx = (float)(ax[i] / (double)c);
                    float my = (float)(ay[i] / (double)c);
                    float mxx = (float)(axx[i] / (double)c);
                    float mxy = (float)(axy[i] / (double)c);
                    float var = mxx - mx * mx;
                    if (var != 0.0f && std::isfinite(mx) &&
                        std::isfinite(mxx) && std::isfinite(mxy)) {
                        bool ok = true;
                        if (use_min_range) {
                            float rngv = std::sqrt(var);
                            ok = std::isfinite(rngv) && rngv >= min_range;
                        }
                        if (ok)
                            g = (mxy - mx * my) / var;
                    }
                }
                orow[i] = g;
            }
        }
    };

    for (unsigned t = 0; t < nthreads; t++) {
        int64_t s = t * chunk;
        int64_t e = std::min<int64_t>(nx, s + chunk);
        if (s >= e) break;
        threads.emplace_back(run_slice, s, e);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host OI solver (reference src/api/oi.cpp:221-341; mirrors the XLA path in
// gridpp_tpu/ops/oi.py _solve_selected + the structure-function kernels in
// gridpp_tpu/structure.py:38-86). Per gridpoint: candidate rho against the
// padded shortlist, stable top-max_points selection (ties keep candidate
// order, like lax.top_k), S x S correlation assembly with a ratio ridge,
// Gauss-Jordan solve without pivoting (SPD + identity rows), increment with
// the optional anti-extrapolation clamp, and the analysis-variance update.
// Threaded over gridpoints; the XLA:CPU fused program runs this path
// effectively single-threaded (~40 s at 2000^2/10k).

namespace {

inline float rho_kernel(int type, float dist, float length) {
    // matches structure.py _barnes/_cressman/_soar/_toar/_powerlaw_rho:
    // invalid/zero length -> factor disabled (1); non-finite dist -> 0
    if (!std::isfinite(length) || length == 0.0f) return 1.0f;
    if (!std::isfinite(dist)) return 0.0f;
    switch (type) {
        case 0: {  // barnes
            float v = dist / length;
            return std::exp(-0.5f * v * v);
        }
        case 1: {  // cressman
            if (std::fabs(dist) >= std::fabs(length)) return 0.0f;
            float ll = length * length, dd = dist * dist;
            return (ll - dd) / (ll + dd);
        }
        case 2: {  // soar
            float v = std::fabs(dist) / length;
            return (1.0f + v) * std::exp(-v);
        }
        case 3: {  // toar
            float v = std::fabs(dist) / length;
            return (1.0f + v + (v * v) / 3.0f) * std::exp(-v);
        }
        case 4: {  // powerlaw
            float v = dist / length;
            return 1.0f / (1.0f + 0.5f * v * v);
        }
    }
    return 0.0f;
}

inline float pair_corr(int type, float dx, float dy, float dz,
                       float e1, float e2, float l1, float l2,
                       float h, float v, float w, float loc) {
    float hd = std::sqrt(dx * dx + dy * dy + dz * dz);
    float rho = rho_kernel(type, hd, h);
    if (valid(e1) && valid(e2)) rho *= rho_kernel(type, e1 - e2, v);
    if (valid(l1) && valid(l2)) rho *= rho_kernel(type, l1 - l2, w);
    if (!(hd <= loc)) rho = 0.0f;
    return rho;
}

// Candidate filter + stable top-max_points selection shared by every
// native OI-family solver. Semantics must exactly mirror the XLA path:
// rho > 0 reproduces the radius query, and the stable sort keeps
// candidate order on rho ties like lax.top_k. Returns S (0 = skip) and
// fills gsel (global obs ids, rho-descending) and g (their rhos).
struct SelScratch {
    std::vector<int> sel, order;
    std::vector<float> rho;
};

inline int select_topk(
    const int32_t* ci, const uint8_t* mi, int64_t kpad, int kernel_type,
    float gxi, float gyi, float gzi, float gelevi, float glafi,
    float ghi, float gvi, float gwi, float gloci,
    const float* ox, const float* oy, const float* oz,
    const float* oelev, const float* olaf,
    int max_points, SelScratch& sc, std::vector<int>& gsel,
    std::vector<double>& g) {
    if ((int64_t)sc.sel.size() < kpad) {
        sc.sel.resize(kpad);
        sc.order.resize(kpad);
        sc.rho.resize(kpad);
    }
    int cnt = 0;
    for (int64_t k = 0; k < kpad; k++) {
        if (!mi[k]) continue;
        int o = ci[k];
        float r = pair_corr(kernel_type, gxi - ox[o], gyi - oy[o],
                            gzi - oz[o], gelevi, oelev[o], glafi, olaf[o],
                            ghi, gvi, gwi, gloci);
        if (!(r > 0.0f)) continue;
        sc.sel[cnt] = o;
        sc.rho[cnt] = r;
        cnt++;
    }
    if (cnt == 0) return 0;
    int S = (max_points > 0 && max_points < cnt) ? max_points : cnt;
    for (int k = 0; k < cnt; k++) sc.order[k] = k;
    std::stable_sort(sc.order.begin(), sc.order.begin() + cnt,
                     [&](int a, int b) { return sc.rho[a] > sc.rho[b]; });
    gsel.assign(S, 0);
    g.assign(S, 0.0);
    for (int k = 0; k < S; k++) {
        gsel[k] = sc.sel[sc.order[k]];
        g[k] = sc.rho[sc.order[k]];
    }
    return S;
}

}  // namespace

extern "C" {

// Canonical pair-rho evaluation over explicit candidate lists: the same
// pair_corr the native OI-family solvers run in select_topk, exposed so
// the serving pipelines / device API paths can store selection keys that
// are BIT-IDENTICAL to the native per-call selection (ops/canonical.py).
// rho_out[i, k] = 0 where the mask is clear.
void pair_rho_host(
    const float* gx, const float* gy, const float* gz,
    const float* gelev, const float* glaf,
    const float* gh, const float* gv, const float* gw, const float* gloc,
    int64_t n,
    const float* ox, const float* oy, const float* oz,
    const float* oelev, const float* olaf,
    const int32_t* cand, const uint8_t* mask, int64_t kpad,
    int kernel_type, float* rho_out) {
    parallel_rows(n, [&](int64_t s0, int64_t e0) {
        for (int64_t i = s0; i < e0; i++) {
            const int32_t* ci = cand + i * kpad;
            const uint8_t* mi = mask + i * kpad;
            float* ri = rho_out + i * kpad;
            for (int64_t k = 0; k < kpad; k++) {
                if (!mi[k]) {
                    ri[k] = 0.0f;
                    continue;
                }
                int o = ci[k];
                ri[k] = pair_corr(kernel_type, gx[i] - ox[o],
                                  gy[i] - oy[o], gz[i] - oz[o],
                                  gelev[i], oelev[o], glaf[i], olaf[o],
                                  gh[i], gv[i], gw[i], gloc[i]);
            }
        }
    });
}

void oi_host_solve(
    const float* gx, const float* gy, const float* gz,
    const float* gelev, const float* glaf,
    const float* gh, const float* gv, const float* gw, const float* gloc,
    int64_t n,
    const float* ox, const float* oy, const float* oz,
    const float* oelev, const float* olaf,
    const float* oh, const float* ov, const float* ow, const float* oloc,
    const float* obs, const float* oyb, const float* oratio,
    const int32_t* cand, const uint8_t* mask, int64_t kpad,
    int kernel_type, int max_points, int allow_extrapolation,
    const float* background, const float* bvariance,
    float* out, float* out_avar) {
    parallel_rows(n, [&](int64_t s0, int64_t e0) {
        SelScratch sc;
        std::vector<double> m;  // (S, S+1) augmented solve matrix
        std::vector<double> g, inno;
        std::vector<int> gsel;
        for (int64_t i = s0; i < e0; i++) {
            float bg = background[i];
            float bvar = bvariance[i];
            out[i] = bg;
            out_avar[i] = bvar;
            int S = select_topk(cand + i * kpad, mask + i * kpad, kpad,
                                kernel_type, gx[i], gy[i], gz[i],
                                gelev[i], glaf[i], gh[i], gv[i], gw[i],
                                gloc[i], ox, oy, oz, oelev, olaf,
                                max_points, sc, gsel, g);
            if (S == 0 || !valid(bg)) continue;
            inno.assign(S, 0.0);
            for (int k = 0; k < S; k++)
                inno[k] = (double)obs[gsel[k]] - (double)oyb[gsel[k]];
            // augmented (S, S+1): obs-obs correlations (h/v/w and the
            // localization radius come from the ROW observation, like the
            // batch-last XLA assembly) + ratio ridge; rhs = g
            // double-precision assembly + solve, like the reference's
            // Armadillo path (oi.cpp:315 operates on arma::mat doubles):
            // strongly correlated obs make the system ill-conditioned
            // and f32 elimination order shifts analyses by ~1e-3
            m.assign((size_t)S * (S + 1), 0.0);
            for (int r = 0; r < S; r++) {
                int orow = gsel[r];
                for (int c = 0; c < S; c++) {
                    int ocol = gsel[c];
                    m[(size_t)r * (S + 1) + c] = pair_corr(
                        kernel_type, ox[orow] - ox[ocol],
                        oy[orow] - oy[ocol], oz[orow] - oz[ocol],
                        oelev[orow], oelev[ocol], olaf[orow], olaf[ocol],
                        oh[orow], ov[orow], ow[orow], oloc[orow]);
                }
                m[(size_t)r * (S + 1) + r] += oratio[orow];
                m[(size_t)r * (S + 1) + S] = g[r];
            }
            // Gauss-Jordan without pivoting (SPD by construction)
            for (int k = 0; k < S; k++) {
                double invp = 1.0 / m[(size_t)k * (S + 1) + k];
                for (int c = 0; c <= S; c++)
                    m[(size_t)k * (S + 1) + c] *= invp;
                for (int r = 0; r < S; r++) {
                    if (r == k) continue;
                    double f = m[(size_t)r * (S + 1) + k];
                    if (f == 0.0) continue;
                    for (int c = 0; c <= S; c++)
                        m[(size_t)r * (S + 1) + c] -=
                            f * m[(size_t)k * (S + 1) + c];
                }
            }
            double increment = 0.0, a_scalar = 0.0;
            for (int k = 0; k < S; k++) {
                double x = m[(size_t)k * (S + 1) + S];
                increment += x * inno[k];
                a_scalar += x * g[k];
            }
            if (!allow_extrapolation) {
                double max_inc = -std::numeric_limits<double>::infinity();
                double min_inc = std::numeric_limits<double>::infinity();
                for (int k = 0; k < S; k++) {
                    max_inc = std::max<double>(max_inc, inno[k]);
                    min_inc = std::min<double>(min_inc, inno[k]);
                }
                if (max_inc > 0 && increment > max_inc) increment = max_inc;
                else if (max_inc < 0 && increment > 0) increment = max_inc;
                else if (min_inc < 0 && increment < min_inc)
                    increment = min_inc;
                else if (min_inc > 0 && increment < 0) increment = min_inc;
            }
            out[i] = bg + (float)increment;
            out_avar[i] = bvar * (float)(1.0 - a_scalar);
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host EnSI solver (reference src/api/oi_ensi.cpp:114-568; mirrors the XLA
// path in gridpp_tpu/ops/oi_ensi.py _ensi_update with the eigendecomposition
// the reference uses instead of the device path's Newton-Schulz). Double-precision
// local algebra (the reference's Armadillo precision); threaded over
// gridpoints where the reference is single-threaded by necessity (OMP
// disabled, oi_ensi.cpp:203-206).

namespace {

// Cyclic Jacobi eigendecomposition of a symmetric e x e matrix (double).
// a is overwritten; eigenvalues land in w, eigenvectors in columns of q.
bool jacobi_eigh(int e, double* a, double* w, double* q) {
    for (int i = 0; i < e; i++)
        for (int j = 0; j < e; j++) q[i * e + j] = (i == j) ? 1.0 : 0.0;
    double diagsq0 = 0.0;
    for (int i = 0; i < e; i++) diagsq0 += a[i * e + i] * a[i * e + i];
    const double tol = 1e-24 * (diagsq0 + 1e-300);
    for (int sweep = 0; sweep < 50; sweep++) {
        double off = 0.0;
        for (int i = 0; i < e; i++)
            for (int j = i + 1; j < e; j++) off += a[i * e + j] * a[i * e + j];
        if (off <= tol) break;  // relative: quadratic convergence lands
                                // here in ~5-8 sweeps
        for (int p = 0; p < e; p++) {
            for (int r = p + 1; r < e; r++) {
                double apr = a[p * e + r];
                if (apr == 0.0) continue;
                double app = a[p * e + p], arr = a[r * e + r];
                double tau = (arr - app) / (2.0 * apr);
                double t = (tau >= 0 ? 1.0 : -1.0) /
                           (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
                double c = 1.0 / std::sqrt(1.0 + t * t);
                double s = t * c;
                for (int k = 0; k < e; k++) {
                    double akp = a[k * e + p], akr = a[k * e + r];
                    a[k * e + p] = c * akp - s * akr;
                    a[k * e + r] = s * akp + c * akr;
                }
                for (int k = 0; k < e; k++) {
                    double apk = a[p * e + k], ark = a[r * e + k];
                    a[p * e + k] = c * apk - s * ark;
                    a[r * e + k] = s * apk + c * ark;
                }
                for (int k = 0; k < e; k++) {
                    double qkp = q[k * e + p], qkr = q[k * e + r];
                    q[k * e + p] = c * qkp - s * qkr;
                    q[k * e + r] = s * qkp + c * qkr;
                }
            }
        }
    }
    bool ok = true;
    for (int i = 0; i < e; i++) {
        w[i] = a[i * e + i];
        if (!std::isfinite(w[i]) || w[i] <= 0.0) ok = false;
    }
    return ok;
}

}  // namespace

extern "C" {

void oi_ensi_host_solve(
    const float* gx, const float* gy, const float* gz,
    const float* gelev, const float* glaf,
    const float* gh, const float* gv, const float* gw, const float* gloc,
    int64_t n,
    const float* ox, const float* oy, const float* oz,
    const float* oelev, const float* olaf,
    const float* oh, const float* ov, const float* ow, const float* oloc,
    const float* obs, const float* sigmas, const float* yhat,
    const float* yanom,  // (P, E) row-major
    const int32_t* cand, const uint8_t* mask, int64_t kpad,
    int kernel_type, int max_points, int allow_extrapolation, int n_ens,
    const float* background,  // (n, E)
    float* out,               // (n, E)
    uint8_t* cond_bad) {
    const int E = n_ens;
    parallel_rows(n, [&](int64_t s0, int64_t e0) {
        SelScratch sc;
        std::vector<int> gsel;
        std::vector<double> Y, C, Pinv, Qv, lam, cv, wv, Wm, x, inno, g;
        for (int64_t i = s0; i < e0; i++) {
            const float* bg = background + i * E;
            float* oi = out + i * E;
            for (int j = 0; j < E; j++) oi[j] = bg[j];
            cond_bad[i] = 0;
            int S = select_topk(cand + i * kpad, mask + i * kpad, kpad,
                                kernel_type, gx[i], gy[i], gz[i],
                                gelev[i], glaf[i], gh[i], gv[i], gw[i],
                                gloc[i], ox, oy, oz, oelev, olaf,
                                max_points, sc, gsel, g);
            if (S == 0) continue;
            inno.assign(S, 0.0);
            for (int k = 0; k < S; k++)
                inno[k] = (double)obs[gsel[k]] - (double)yhat[gsel[k]];
            // Rinv diag = rho / sigma^2; C = Y^T Rinv; Pinv = C Y + (E-1) I
            Y.assign((size_t)S * E, 0.0);
            for (int k = 0; k < S; k++)
                for (int j = 0; j < E; j++)
                    Y[(size_t)k * E + j] = yanom[(size_t)gsel[k] * E + j];
            C.assign((size_t)E * S, 0.0);
            for (int k = 0; k < S; k++) {
                double sg = sigmas[gsel[k]];
                double rinv = g[k] / (sg * sg);
                for (int j = 0; j < E; j++)
                    C[(size_t)j * S + k] = Y[(size_t)k * E + j] * rinv;
            }
            Pinv.assign((size_t)E * E, 0.0);
            for (int a = 0; a < E; a++)
                for (int b = 0; b < E; b++) {
                    double acc = 0.0;
                    for (int k = 0; k < S; k++)
                        acc += C[(size_t)a * S + k] * Y[(size_t)k * E + b];
                    Pinv[(size_t)a * E + b] = acc;
                }
            for (int a = 0; a < E; a++)
                for (int b = a + 1; b < E; b++) {
                    double m2 = 0.5 * (Pinv[(size_t)a * E + b]
                                       + Pinv[(size_t)b * E + a]);
                    Pinv[(size_t)a * E + b] = m2;
                    Pinv[(size_t)b * E + a] = m2;
                }
            for (int a = 0; a < E; a++) Pinv[(size_t)a * E + a] += E - 1;
            bool finite = true;
            for (int a = 0; a < E * E; a++)
                if (!std::isfinite(Pinv[a])) finite = false;
            Qv.assign((size_t)E * E, 0.0);
            lam.assign(E, 0.0);
            if (!finite || !jacobi_eigh(E, Pinv.data(), lam.data(),
                                        Qv.data())) {
                cond_bad[i] = 1;  // keep the raw background
                continue;
            }
            // W = sqrt(E-1) Q lam^{-1/2} Q^T; w = Q lam^{-1} Q^T (C inno)
            cv.assign(E, 0.0);
            for (int a = 0; a < E; a++)
                for (int k = 0; k < S; k++)
                    cv[a] += C[(size_t)a * S + k] * inno[k];
            wv.assign(E, 0.0);
            // w = Q diag(1/lam) Q^T cv
            {
                std::vector<double>& tmp = Wm;  // reuse buffer
                tmp.assign(E, 0.0);
                for (int b = 0; b < E; b++) {
                    double acc = 0.0;
                    for (int a = 0; a < E; a++)
                        acc += Qv[(size_t)a * E + b] * cv[a];
                    tmp[b] = acc / lam[b];
                }
                for (int a = 0; a < E; a++) {
                    double acc = 0.0;
                    for (int b = 0; b < E; b++)
                        acc += Qv[(size_t)a * E + b] * tmp[b];
                    wv[a] = acc;
                }
            }
            // member anomalies
            double mean = 0.0;
            bool bgfin = true;
            for (int j = 0; j < E; j++) {
                if (!std::isfinite(bg[j])) bgfin = false;
                mean += bg[j];
            }
            mean /= E;
            if (!bgfin) continue;  // member screening is done upstream
            x.assign(E, 0.0);
            for (int j = 0; j < E; j++) x[j] = bg[j] - mean;
            // Wx = sqrt(E-1) Q lam^{-1/2} Q^T x
            std::vector<double>& tmp = Wm;
            tmp.assign(E, 0.0);
            for (int b = 0; b < E; b++) {
                double acc = 0.0;
                for (int a = 0; a < E; a++)
                    acc += Qv[(size_t)a * E + b] * x[a];
                tmp[b] = acc / std::sqrt(lam[b]);
            }
            double xw = 0.0;
            for (int j = 0; j < E; j++) xw += x[j] * wv[j];
            bool okp = true;
            std::vector<double>& incr = cv;  // reuse
            double sq = std::sqrt((double)(E - 1));
            for (int ee = 0; ee < E; ee++) {
                double wx = 0.0;
                for (int b = 0; b < E; b++)
                    wx += Qv[(size_t)ee * E + b] * tmp[b];
                incr[ee] = sq * wx + xw;
            }
            if (!allow_extrapolation) {
                for (int ee = 0; ee < E; ee++) {
                    // reference quirk (oi_ensi.cpp:520-537): lY[e] is the
                    // e-th element of the column-major flattened Y
                    int obs_i = ee % S;
                    int mem_j = ee / S;
                    double yel = Y[(size_t)obs_i * E + mem_j];
                    double max_inc = -std::numeric_limits<double>::infinity();
                    double min_inc = std::numeric_limits<double>::infinity();
                    for (int k = 0; k < S; k++) {
                        double d = inno[k] - yel;
                        max_inc = std::max(max_inc, d);
                        min_inc = std::min(min_inc, d);
                    }
                    double mi2 = incr[ee] - x[ee];
                    if (max_inc > 0 && mi2 > max_inc) incr[ee] = max_inc + x[ee];
                    else if (max_inc < 0 && mi2 > 0) incr[ee] = x[ee];
                    else if (min_inc < 0 && mi2 < min_inc)
                        incr[ee] = min_inc + x[ee];
                    else if (min_inc > 0 && mi2 < 0) incr[ee] = x[ee];
                }
            }
            for (int ee = 0; ee < E; ee++) {
                double an = mean + incr[ee];
                if (!std::isfinite(an)) { okp = false; break; }
            }
            if (!okp) continue;
            for (int ee = 0; ee < E; ee++) oi[ee] = (float)(mean + incr[ee]);
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host ensi_multi solvers (reference src/api/oi_ensi_multi.cpp; mirror the
// XLA kernels in gridpp_tpu/ops/oi_ensi_multi.py). Threaded per-gridpoint;
// double-precision local algebra.

extern "C" {

// ebe / ebesc member-by-member update (_member_update): one gain solve per
// gridpoint applied to E member innovations. use_z=1 (ebe): pair corr is the
// localization Schur ensemble product loc o (z z^T) and the numerator row is
// rho o (x_l . z^T) (oi_ensi_multi.cpp:524-579); use_z=0 (ebesc): structure
// correlations directly (629-860).
void oi_member_host_solve(
    const float* gx, const float* gy, const float* gz,
    const float* gelev, const float* glaf,
    const float* gh, const float* gv, const float* gw, const float* gloc,
    int64_t n,
    const float* ox, const float* oy, const float* oz,
    const float* oelev, const float* olaf,
    const float* oh, const float* ov, const float* ow, const float* oloc,
    const float* oratio,
    const float* innov,   // (P, E) member innovations
    const float* zr,      // (P, E) normalized obs anomalies (use_z)
    const float* xl,      // (n, E) normalized grid anomalies (use_z)
    const float* bratios, // (n,)
    const int32_t* cand, const uint8_t* mask, int64_t kpad,
    int kernel_type, int max_points, int allow_extrapolation, int n_ens,
    int use_z,
    const float* background,  // (n, E)
    float* out) {
    const int E = n_ens;
    parallel_rows(n, [&](int64_t s0, int64_t e0) {
        SelScratch sc;
        std::vector<int> gsel;
        std::vector<double> m, g, lk, dx;
        for (int64_t i = s0; i < e0; i++) {
            const float* bg = background + i * E;
            float* oi = out + i * E;
            for (int j = 0; j < E; j++) oi[j] = bg[j];
            int S = select_topk(cand + i * kpad, mask + i * kpad, kpad,
                                kernel_type, gx[i], gy[i], gz[i],
                                gelev[i], glaf[i], gh[i], gv[i], gw[i],
                                gloc[i], ox, oy, oz, oelev, olaf,
                                max_points, sc, gsel, g);
            if (S == 0) continue;
            if (use_z) {
                // numerator: rho o (x_l . z^T); selection stays on the
                // structure rho (make_ebe_kernel's _select does too)
                for (int k = 0; k < S; k++) {
                    double acc = 0.0;
                    for (int e = 0; e < E; e++)
                        acc += (double)xl[(size_t)i * E + e]
                             * (double)zr[(size_t)gsel[k] * E + e];
                    g[k] *= acc;
                }
            }
            // augmented (S, S+1) system
            m.assign((size_t)S * (S + 1), 0.0);
            for (int r = 0; r < S; r++) {
                int orow = gsel[r];
                for (int c = 0; c < S; c++) {
                    int ocol = gsel[c];
                    double pc = pair_corr(
                        kernel_type, ox[orow] - ox[ocol],
                        oy[orow] - oy[ocol], oz[orow] - oz[ocol],
                        oelev[orow], oelev[ocol], olaf[orow], olaf[ocol],
                        oh[orow], ov[orow], ow[orow], oloc[orow]);
                    if (use_z) {
                        double acc = 0.0;
                        for (int e = 0; e < E; e++)
                            acc += (double)zr[(size_t)orow * E + e]
                                 * (double)zr[(size_t)ocol * E + e];
                        pc *= acc;
                    }
                    m[(size_t)r * (S + 1) + c] = pc;
                }
                m[(size_t)r * (S + 1) + r] += oratio[orow];
                m[(size_t)r * (S + 1) + S] = g[r];
            }
            for (int k = 0; k < S; k++) {
                double invp = 1.0 / m[(size_t)k * (S + 1) + k];
                for (int c = 0; c <= S; c++)
                    m[(size_t)k * (S + 1) + c] *= invp;
                for (int r = 0; r < S; r++) {
                    if (r == k) continue;
                    double f = m[(size_t)r * (S + 1) + k];
                    if (f == 0.0) continue;
                    for (int c = 0; c <= S; c++)
                        m[(size_t)r * (S + 1) + c] -=
                            f * m[(size_t)k * (S + 1) + c];
                }
            }
            lk.assign(S, 0.0);
            for (int k = 0; k < S; k++) lk[k] = m[(size_t)k * (S + 1) + S];
            dx.assign(E, 0.0);
            double br = bratios[i];
            bool fin = true;
            for (int e = 0; e < E; e++) {
                double acc = 0.0;
                for (int k = 0; k < S; k++)
                    acc += lk[k] * (double)innov[(size_t)gsel[k] * E + e];
                dx[e] = br * acc;
                if (!allow_extrapolation) {
                    double max_inc =
                        -std::numeric_limits<double>::infinity();
                    double min_inc =
                        std::numeric_limits<double>::infinity();
                    for (int k = 0; k < S; k++) {
                        double d = innov[(size_t)gsel[k] * E + e];
                        max_inc = std::max(max_inc, d);
                        min_inc = std::min(min_inc, d);
                    }
                    if (max_inc > 0 && dx[e] > max_inc) dx[e] = max_inc;
                    else if (max_inc < 0 && dx[e] > 0) dx[e] = 0.0;
                    else if (min_inc < 0 && dx[e] < min_inc) dx[e] = min_inc;
                    else if (min_inc > 0 && dx[e] < 0) dx[e] = 0.0;
                }
                if (!std::isfinite(dx[e])) fin = false;
            }
            if (!fin) continue;
            for (int e = 0; e < E; e++) oi[e] = (float)(bg[e] + dx[e]);
        }
    });
}

// utem ETKF update (_utem_core / oi_ensi_multi.cpp:862-1311): like EnSI but
// Rinv uses the error-variance RATIOS, Pinv gets + I (not +(E-1)I),
// correlation anomalies come from a second ensemble, and the increment is
// scaled by the per-point ensemble std (population) and bratios.
void oi_utem_host_solve(
    const float* gx, const float* gy, const float* gz,
    const float* gelev, const float* glaf,
    const float* gh, const float* gv, const float* gw, const float* gloc,
    int64_t n,
    const float* ox, const float* oy, const float* oz,
    const float* oelev, const float* olaf,
    const float* oh, const float* ov, const float* ow, const float* oloc,
    const float* obs, const float* oratio, const float* yhat,
    const float* yanom,   // (P, E) physical anomalies (pbackground)
    const float* ycorr,   // (P, E) normalized anomalies (pbackground_corr)
    const float* bratios, // (n,)
    const int32_t* cand, const uint8_t* mask, int64_t kpad,
    int kernel_type, int max_points, int allow_extrapolation, int n_ens,
    double min_std,
    const float* background,       // (n, E)
    const float* background_corr,  // (n, E)
    float* out,                    // (n, E)
    uint8_t* cond_bad) {
    const int E = n_ens;
    parallel_rows(n, [&](int64_t s0, int64_t e0) {
        SelScratch sc;
        std::vector<int> gsel;
        std::vector<double> Yc, C, Pinv, Qv, lam, cv, wv, tmp, xc, inno,
            g, incr;
        for (int64_t i = s0; i < e0; i++) {
            const float* bg = background + i * E;
            const float* bgc = background_corr + i * E;
            float* oi = out + i * E;
            for (int j = 0; j < E; j++) oi[j] = bg[j];
            cond_bad[i] = 0;
            int S = select_topk(cand + i * kpad, mask + i * kpad, kpad,
                                kernel_type, gx[i], gy[i], gz[i],
                                gelev[i], glaf[i], gh[i], gv[i], gw[i],
                                gloc[i], ox, oy, oz, oelev, olaf,
                                max_points, sc, gsel, g);
            if (S == 0) continue;
            inno.assign(S, 0.0);
            for (int k = 0; k < S; k++)
                inno[k] = (double)obs[gsel[k]] - (double)yhat[gsel[k]];
            // C = Ycorr^T Rinv with Rinv = rho / ratio; Pinv = C Ycorr + I
            Yc.assign((size_t)S * E, 0.0);
            for (int k = 0; k < S; k++)
                for (int j = 0; j < E; j++)
                    Yc[(size_t)k * E + j] = ycorr[(size_t)gsel[k] * E + j];
            C.assign((size_t)E * S, 0.0);
            for (int k = 0; k < S; k++) {
                double rinv = g[k] / (double)oratio[gsel[k]];
                for (int j = 0; j < E; j++)
                    C[(size_t)j * S + k] = Yc[(size_t)k * E + j] * rinv;
            }
            Pinv.assign((size_t)E * E, 0.0);
            for (int a = 0; a < E; a++)
                for (int b = 0; b < E; b++) {
                    double acc = 0.0;
                    for (int k = 0; k < S; k++)
                        acc += C[(size_t)a * S + k] * Yc[(size_t)k * E + b];
                    Pinv[(size_t)a * E + b] = acc;
                }
            for (int a = 0; a < E; a++)
                for (int b = a + 1; b < E; b++) {
                    double m2 = 0.5 * (Pinv[(size_t)a * E + b]
                                       + Pinv[(size_t)b * E + a]);
                    Pinv[(size_t)a * E + b] = m2;
                    Pinv[(size_t)b * E + a] = m2;
                }
            for (int a = 0; a < E; a++) Pinv[(size_t)a * E + a] += 1.0;
            bool finite = true;
            for (int a = 0; a < E * E; a++)
                if (!std::isfinite(Pinv[a])) finite = false;
            Qv.assign((size_t)E * E, 0.0);
            lam.assign(E, 0.0);
            if (!finite || !jacobi_eigh(E, Pinv.data(), lam.data(),
                                        Qv.data())) {
                cond_bad[i] = 1;
                continue;
            }
            // w = Q lam^{-1} Q^T (C inno)
            cv.assign(E, 0.0);
            for (int a = 0; a < E; a++)
                for (int k = 0; k < S; k++)
                    cv[a] += C[(size_t)a * S + k] * inno[k];
            tmp.assign(E, 0.0);
            for (int b = 0; b < E; b++) {
                double acc = 0.0;
                for (int a = 0; a < E; a++)
                    acc += Qv[(size_t)a * E + b] * cv[a];
                tmp[b] = acc / lam[b];
            }
            wv.assign(E, 0.0);
            for (int a = 0; a < E; a++) {
                double acc = 0.0;
                for (int b = 0; b < E; b++)
                    acc += Qv[(size_t)a * E + b] * tmp[b];
                wv[a] = acc;
            }
            // grid-side stats: ens mean/std of background; normalized
            // anomalies of background_corr (DEFAULT_MIN_STD rules)
            double mean = 0.0, meanc = 0.0;
            for (int j = 0; j < E; j++) {
                mean += bg[j];
                meanc += bgc[j];
            }
            mean /= E;
            meanc /= E;
            double var = 0.0, varc = 0.0;
            for (int j = 0; j < E; j++) {
                var += (bg[j] - mean) * (bg[j] - mean);
                varc += (bgc[j] - meanc) * (bgc[j] - meanc);
            }
            double ens_std = std::sqrt(var / E);   // population std
            double stdc = std::sqrt(varc / E);
            double cf = 1.0 / std::sqrt((double)std::max(E - 1, 1));
            xc.assign(E, 0.0);
            if (std::isfinite(stdc) && stdc > min_std)
                for (int j = 0; j < E; j++)
                    xc[j] = cf * (bgc[j] - meanc) / (stdc == 0 ? 1 : stdc);
            // increment = ens_std sqrt(E-1) Q lam^{-1/2} Q^T x_corr
            //           + bratios (x_corr . w)
            tmp.assign(E, 0.0);
            for (int b = 0; b < E; b++) {
                double acc = 0.0;
                for (int a = 0; a < E; a++)
                    acc += Qv[(size_t)a * E + b] * xc[a];
                tmp[b] = acc / std::sqrt(lam[b]);
            }
            double xw = 0.0;
            for (int j = 0; j < E; j++) xw += xc[j] * wv[j];
            double sq = std::sqrt((double)(E - 1));
            double br = bratios[i];
            incr.assign(E, 0.0);
            for (int ee = 0; ee < E; ee++) {
                double wx = 0.0;
                for (int b = 0; b < E; b++)
                    wx += Qv[(size_t)ee * E + b] * tmp[b];
                incr[ee] = ens_std * sq * wx + br * xw;
            }
            if (!allow_extrapolation) {
                for (int ee = 0; ee < E; ee++) {
                    int obs_i = ee % S;
                    int mem_j = ee / S;
                    double yel = yanom[(size_t)gsel[obs_i] * E + mem_j];
                    double max_inc =
                        -std::numeric_limits<double>::infinity();
                    double min_inc =
                        std::numeric_limits<double>::infinity();
                    for (int k = 0; k < S; k++) {
                        double d = inno[k] - yel;
                        max_inc = std::max(max_inc, d);
                        min_inc = std::min(min_inc, d);
                    }
                    double x_e = bg[ee] - mean;
                    double mi2 = incr[ee] - x_e;
                    if (max_inc > 0 && mi2 > max_inc) incr[ee] = max_inc + x_e;
                    else if (max_inc < 0 && mi2 > 0) incr[ee] = x_e;
                    else if (min_inc < 0 && mi2 < min_inc)
                        incr[ee] = min_inc + x_e;
                    else if (min_inc > 0 && mi2 < 0) incr[ee] = x_e;
                }
            }
            bool okp = true;
            for (int ee = 0; ee < E; ee++)
                if (!std::isfinite(mean + incr[ee])) okp = false;
            if (!okp) continue;
            for (int ee = 0; ee < E; ee++) oi[ee] = (float)(mean + incr[ee]);
        }
    });
}

// ---------------------------------------------------------------------------
// local_distribution_correction host kernel
// (reference src/api/local_distribution_correction.cpp:18-203).
//
// Same algorithm as the jitted path in ops/ldc.py, threaded over
// gridpoint slabs: per gridpoint, gather the valid (obs, fcst, rho)
// pairs from the candidate shortlist, build rho-weighted trimmed
// quantile curves for obs and fcst (stable sort by value, cumulative
// rho normalized into [minq, maxq]), then apply the piecewise
// precipitation rules. The jitted path's (M+1)-point tail-clamped curve
// is equivalent to the (kcount+1)-point curve built here under
// interp_curve's flat-interval rules (repeated tail x-values collapse
// to the first/last occurrence), so results match to float rounding.
//
// bg:   (n,) flattened background
// cand: (n, k) candidate obs ids; mask: (n, k) validity
// rho:  (n, k) structure-function correlations
// obs/fcst: (t, s_obs) row-major observation / forecast-at-obs values
// out:  (n,)
void ldc_host(const float* bg, int64_t n, const int32_t* cand,
              const uint8_t* mask, const float* rho, int64_t k,
              const float* obs, const float* fcst, int64_t t,
              int64_t s_obs, float minq, float maxq, int32_t min_points,
              float* out) {
    parallel_rows(n, [&](int64_t rs, int64_t re) {
        const int64_t m = k * t;
        std::vector<float> ov, fv, rv;       // valid pairs, flat order
        std::vector<int32_t> ord;
        std::vector<float> rcv, rcq, fcv, fcq;  // curves (vals, quant)
        ov.reserve(m);
        fv.reserve(m);
        rv.reserve(m);
        ord.reserve(m);
        rcv.reserve(m + 1);
        rcq.reserve(m + 1);
        fcv.reserve(m + 1);
        fcq.reserve(m + 1);
        for (int64_t i = rs; i < re; i++) {
            const float b = bg[i];
            ov.clear();
            fv.clear();
            rv.clear();
            float sum_rho = 0.0f;
            for (int64_t ki = 0; ki < k; ki++) {
                if (!mask[i * k + ki]) continue;
                const float r = rho[i * k + ki];
                const int64_t c = cand[i * k + ki];
                for (int64_t ti = 0; ti < t; ti++) {
                    const float o = obs[ti * s_obs + c];
                    const float f = fcst[ti * s_obs + c];
                    if (!(std::isfinite(o) && std::isfinite(f) &&
                          o >= 0.0f && f >= 0.0f))
                        continue;
                    ov.push_back(o);
                    fv.push_back(f);
                    rv.push_back(r);
                    sum_rho += r;
                }
            }
            const int32_t count = (int32_t)ov.size();
            if (count < min_points || !std::isfinite(b)) {
                out[i] = b;
                continue;
            }
            const int32_t d0 = (int32_t)((float)count * minq);
            const int32_t d1 = (int32_t)((float)count * maxq);
            const int32_t kcount = std::max(d1 - d0, 0);
            float r_last = 0.0f, f_last = 0.0f;
            if (kcount > 0) {
                auto build = [&](const std::vector<float>& vals,
                                 std::vector<float>& cv,
                                 std::vector<float>& cq, float& lastval) {
                    ord.resize(count);
                    for (int32_t j = 0; j < count; j++) ord[j] = j;
                    std::stable_sort(
                        ord.begin(), ord.end(),
                        [&](int32_t a, int32_t bi) {
                            return vals[a] < vals[bi];
                        });
                    cv.clear();
                    cq.clear();
                    cv.push_back(0.0f);  // leading (0, 0) curve point
                    cq.push_back(0.0f);
                    float total = 0.0f;
                    for (int32_t j = d0; j < d1; j++) total += rv[ord[j]];
                    const float tden = (total == 0.0f) ? 1.0f : total;
                    float csum = 0.0f;
                    for (int32_t j = d0; j < d1; j++) {
                        csum += rv[ord[j]];
                        float q = minq + csum / tden * (maxq - minq);
                        cv.push_back(vals[ord[j]]);
                        cq.push_back(std::min(q, maxq));
                    }
                    lastval = vals[ord[d1 - 1]];
                };
                build(ov, rcv, rcq, r_last);
                build(fv, fcv, fcq, f_last);
            }
            float result;
            if (b < 0.01f) {
                result = 0.0f;  // rule 1: dry background stays dry
            } else if (r_last <= 0.0f) {
                // rule 2: no observed rain (2a clear-air / 2c convection)
                result = (b < 3.0f * f_last || b < 0.1f) ? 0.0f : b;
            } else if (b >= f_last) {
                // rule 3: above the curve, preserve end-of-curve bias
                result = b + (r_last - f_last);
            } else {
                // rule 4: quantile map inside the curve, density blend
                const float q = interp_curve(b, fcv.data(), fcq.data(),
                                             (int64_t)fcv.size());
                const float nr = interp_curve(q, rcq.data(), rcv.data(),
                                              (int64_t)rcv.size());
                const float w0 = 1.0f - std::exp(-0.01f * sum_rho);
                result = w0 * nr + (1.0f - w0) * b;
            }
            out[i] = result;
        }
    });
}

}  // extern "C"
