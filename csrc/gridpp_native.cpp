// Native host-side spatial index for gridpp_tpu.
//
// Replaces the role of the reference's boost R-tree (reference
// src/api/kdtree.cpp) at precompute time: building gather maps between
// grids and padded neighbour lists for OI. Apply-time work runs on the
// device; this engine only has to make the one-time host precompute fast.
//
// Design: a 3-D cell hash over ECEF coordinates. Points on the Earth's
// surface occupy a 2-D shell, so the cell size is derived from the
// surface density. Queries walk expanding Chebyshev shells of cells.
// Multithreaded over query ranges with std::thread.
//
// C ABI (ctypes-friendly):
//   index_build(xyz, n, cell_hint) -> handle
//   index_free(handle)
//   index_nearest(handle, q, nq, out_idx)
//   index_knearest(handle, q, nq, k, out_idx, out_dist)
//   index_radius_count(handle, q, nq, radius, out_count)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Index {
    std::vector<double> xs, ys, zs;
    double cell;
    double minx, miny, minz;
    // occupied cell bounding box (query shells clamp to this, so
    // degenerate geometries never walk empty space)
    int64_t c0[3], c1[3];
    // cell key -> [start, end) into order
    std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> cells;
    std::vector<int32_t> order;  // point ids grouped by cell
    int64_t n;

    inline uint64_t key(int64_t ix, int64_t iy, int64_t iz) const {
        // 21 bits per axis, offset to keep non-negative
        const uint64_t off = 1 << 20;
        return ((uint64_t)(ix + off) << 42) | ((uint64_t)(iy + off) << 21)
               | (uint64_t)(iz + off);
    }
    inline void cell_of(double x, double y, double z, int64_t& ix,
                        int64_t& iy, int64_t& iz) const {
        ix = (int64_t)std::floor((x - minx) / cell);
        iy = (int64_t)std::floor((y - miny) / cell);
        iz = (int64_t)std::floor((z - minz) / cell);
    }
};

inline double dist2(const Index& idx, int32_t i, double x, double y,
                    double z) {
    const double dx = idx.xs[i] - x;
    const double dy = idx.ys[i] - y;
    const double dz = idx.zs[i] - z;
    return dx * dx + dy * dy + dz * dz;
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    unsigned nt = std::max(1u, std::thread::hardware_concurrency());
    if (n < 4096 || nt == 1) {
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

// Chebyshev distance from a cell to the occupied box (0 when inside)
inline int64_t box_cheb(const Index& idx, int64_t cx, int64_t cy,
                        int64_t cz) {
    int64_t d = 0;
    int64_t c[3] = {cx, cy, cz};
    for (int dd = 0; dd < 3; dd++) {
        if (c[dd] < idx.c0[dd]) d = std::max(d, idx.c0[dd] - c[dd]);
        if (c[dd] > idx.c1[dd]) d = std::max(d, c[dd] - idx.c1[dd]);
    }
    return d;
}

inline int64_t box_cheb_max(const Index& idx, int64_t cx, int64_t cy,
                            int64_t cz) {
    int64_t d = 0;
    int64_t c[3] = {cx, cy, cz};
    for (int dd = 0; dd < 3; dd++) {
        d = std::max(d, std::abs(c[dd] - idx.c0[dd]));
        d = std::max(d, std::abs(c[dd] - idx.c1[dd]));
    }
    return d;
}

// Visit every cell on the shell at Chebyshev radius r, clamped to the
// occupied box.
template <class F>
inline void for_shell(const Index& idx, int64_t cx, int64_t cy, int64_t cz,
                      int64_t r, F&& visit) {
    int64_t x0 = std::max(cx - r, idx.c0[0]), x1 = std::min(cx + r, idx.c1[0]);
    int64_t y0 = std::max(cy - r, idx.c0[1]), y1 = std::min(cy + r, idx.c1[1]);
    int64_t z0 = std::max(cz - r, idx.c0[2]), z1 = std::min(cz + r, idx.c1[2]);
    for (int64_t ix = x0; ix <= x1; ix++) {
        for (int64_t iy = y0; iy <= y1; iy++) {
            for (int64_t iz = z0; iz <= z1; iz++) {
                if (std::max({std::abs(ix - cx), std::abs(iy - cy),
                              std::abs(iz - cz)}) != r)
                    continue;
                visit(ix, iy, iz);
            }
        }
    }
}

}  // namespace

extern "C" {

void* index_build(const double* xyz, int64_t n, double cell_hint) {
    Index* idx = new Index();
    idx->n = n;
    idx->xs.resize(n);
    idx->ys.resize(n);
    idx->zs.resize(n);
    double minx = std::numeric_limits<double>::infinity(), maxx = -minx;
    double miny = minx, maxy = maxx, minz = minx, maxz = maxx;
    for (int64_t i = 0; i < n; i++) {
        double x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
        idx->xs[i] = x;
        idx->ys[i] = y;
        idx->zs[i] = z;
        minx = std::min(minx, x); maxx = std::max(maxx, x);
        miny = std::min(miny, y); maxy = std::max(maxy, y);
        minz = std::min(minz, z); maxz = std::max(maxz, z);
    }
    double ex = std::max(maxx - minx, 1e-9), ey = std::max(maxy - miny, 1e-9),
           ez = std::max(maxz - minz, 1e-9);
    double cell = cell_hint;
    if (cell <= 0) {
        // points live on a ~2-D surface: estimate spacing from the largest
        // two extents
        double a = ex, b = ey, c = ez;
        if (a < b) std::swap(a, b);
        if (b < c) std::swap(b, c);
        if (a < b) std::swap(a, b);
        double area = std::max(a * b, 1e-9);
        cell = std::sqrt(area / std::max<int64_t>(n, 1)) * 2.0;
        // bound the cell grid to <= ~4096 cells per axis so degenerate
        // (line/point-like) distributions cannot create huge empty walks
        cell = std::max(cell, a / 4096.0);
    }
    idx->cell = cell;
    idx->minx = minx;
    idx->miny = miny;
    idx->minz = minz;

    // counting sort into cells
    std::vector<uint64_t> keys(n);
    idx->cells.reserve(n / 2 + 16);
    for (int d = 0; d < 3; d++) {
        idx->c0[d] = std::numeric_limits<int64_t>::max();
        idx->c1[d] = std::numeric_limits<int64_t>::min();
    }
    for (int64_t i = 0; i < n; i++) {
        int64_t ix, iy, iz;
        idx->cell_of(idx->xs[i], idx->ys[i], idx->zs[i], ix, iy, iz);
        keys[i] = idx->key(ix, iy, iz);
        idx->cells[keys[i]].second++;
        idx->c0[0] = std::min(idx->c0[0], ix);
        idx->c1[0] = std::max(idx->c1[0], ix);
        idx->c0[1] = std::min(idx->c0[1], iy);
        idx->c1[1] = std::max(idx->c1[1], iy);
        idx->c0[2] = std::min(idx->c0[2], iz);
        idx->c1[2] = std::max(idx->c1[2], iz);
    }
    int32_t start = 0;
    for (auto& kv : idx->cells) {
        int32_t cnt = kv.second.second;
        kv.second.first = start;
        kv.second.second = start;  // running cursor
        start += cnt;
    }
    idx->order.resize(n);
    for (int64_t i = 0; i < n; i++) {
        auto& slot = idx->cells[keys[i]];
        idx->order[slot.second++] = (int32_t)i;
    }
    // fix ranges: [first, cursor) now holds the points
    // (cells map: first=start, second=end)
    return idx;
}

void index_free(void* h) { delete (Index*)h; }

static inline void scan_cell(const Index& idx, int64_t ix, int64_t iy,
                             int64_t iz, double qx, double qy, double qz,
                             double& best, int32_t& best_i) {
    auto it = idx.cells.find(idx.key(ix, iy, iz));
    if (it == idx.cells.end()) return;
    for (int32_t p = it->second.first; p < it->second.second; p++) {
        int32_t i = idx.order[p];
        double d = dist2(idx, i, qx, qy, qz);
        if (d < best) {
            best = d;
            best_i = i;
        }
    }
}

void index_nearest(void* h, const double* q, int64_t nq, int32_t* out_idx) {
    const Index& idx = *(Index*)h;
    parallel_for(nq, [&](int64_t s, int64_t e) {
        for (int64_t j = s; j < e; j++) {
            double qx = q[3 * j], qy = q[3 * j + 1], qz = q[3 * j + 2];
            int64_t cx, cy, cz;
            idx.cell_of(qx, qy, qz, cx, cy, cz);
            double best = std::numeric_limits<double>::infinity();
            int32_t best_i = -1;
            int64_t r0 = box_cheb(idx, cx, cy, cz);
            int64_t rmax = box_cheb_max(idx, cx, cy, cz);
            for (int64_t r = r0; r <= rmax; r++) {
                for_shell(idx, cx, cy, cz, r,
                          [&](int64_t ix, int64_t iy, int64_t iz) {
                              scan_cell(idx, ix, iy, iz, qx, qy, qz, best,
                                        best_i);
                          });
                if (best_i >= 0 && std::sqrt(best) <= (double)r * idx.cell)
                    break;
            }
            out_idx[j] = best_i;
        }
    });
}

void index_knearest(void* h, const double* q, int64_t nq, int32_t k,
                    int32_t* out_idx, double* out_dist) {
    const Index& idx = *(Index*)h;
    parallel_for(nq, [&](int64_t s, int64_t e) {
        std::vector<std::pair<double, int32_t>> heap;  // max-heap by dist
        for (int64_t j = s; j < e; j++) {
            double qx = q[3 * j], qy = q[3 * j + 1], qz = q[3 * j + 2];
            int64_t cx, cy, cz;
            idx.cell_of(qx, qy, qz, cx, cy, cz);
            heap.clear();
            int64_t r0 = box_cheb(idx, cx, cy, cz);
            int64_t rmax = box_cheb_max(idx, cx, cy, cz);
            for (int64_t r = r0; r <= rmax; r++) {
                for_shell(idx, cx, cy, cz, r,
                          [&](int64_t ix, int64_t iy, int64_t iz) {
                    auto it = idx.cells.find(idx.key(ix, iy, iz));
                    if (it == idx.cells.end()) return;
                    for (int32_t p = it->second.first;
                         p < it->second.second; p++) {
                        int32_t i = idx.order[p];
                        double d = dist2(idx, i, qx, qy, qz);
                        if ((int32_t)heap.size() < k) {
                            heap.emplace_back(d, i);
                            std::push_heap(heap.begin(), heap.end());
                        } else if (d < heap.front().first) {
                            std::pop_heap(heap.begin(), heap.end());
                            heap.back() = {d, i};
                            std::push_heap(heap.begin(), heap.end());
                        }
                    }
                });
                bool full = (int32_t)heap.size() >= k ||
                            (int64_t)heap.size() >= idx.n;
                double worst = heap.empty()
                                   ? std::numeric_limits<double>::infinity()
                                   : heap.front().first;
                if (full && std::sqrt(worst) <= (double)r * idx.cell) break;
            }
            std::sort_heap(heap.begin(), heap.end());
            for (int32_t m = 0; m < k; m++) {
                if (m < (int32_t)heap.size()) {
                    out_idx[j * k + m] = heap[m].second;
                    out_dist[j * k + m] = std::sqrt(heap[m].first);
                } else {
                    out_idx[j * k + m] = -1;
                    out_dist[j * k + m] =
                        std::numeric_limits<double>::infinity();
                }
            }
        }
    });
}

// Sequential circle painter over the indexed point set (reference
// src/api/fill.cpp:6-41 and doping.cpp:50-93): for query i, every indexed
// point j within radii[i] gets out[j] = values[i] (or src[j] when src is
// given - the fill(outside=true) restore mode). Points are processed in
// order, so later queries overwrite earlier ones exactly like the
// reference's serial loop. Optional per-point elevation gate.
void index_paint(void* h, const double* q, int64_t nq, const double* radii,
                 const float* values, const float* src, const float* pelev,
                 const float* gelev, int32_t check_elev, float max_diff,
                 float* out) {
    const Index& idx = *(Index*)h;
    for (int64_t j = 0; j < nq; j++) {
        double qx = q[3 * j], qy = q[3 * j + 1], qz = q[3 * j + 2];
        double radius = radii[j];
        double r2 = radius * radius;
        int64_t c0x, c0y, c0z, c1x, c1y, c1z;
        idx.cell_of(qx - radius, qy - radius, qz - radius, c0x, c0y, c0z);
        idx.cell_of(qx + radius, qy + radius, qz + radius, c1x, c1y, c1z);
        c0x = std::max(c0x, idx.c0[0]); c1x = std::min(c1x, idx.c1[0]);
        c0y = std::max(c0y, idx.c0[1]); c1y = std::min(c1y, idx.c1[1]);
        c0z = std::max(c0z, idx.c0[2]); c1z = std::min(c1z, idx.c1[2]);
        float pe = pelev ? pelev[j] : 0.0f;
        for (int64_t ix = c0x; ix <= c1x; ix++) {
            for (int64_t iy = c0y; iy <= c1y; iy++) {
                for (int64_t iz = c0z; iz <= c1z; iz++) {
                    auto it = idx.cells.find(idx.key(ix, iy, iz));
                    if (it == idx.cells.end()) continue;
                    for (int32_t p = it->second.first;
                         p < it->second.second; p++) {
                        int32_t i = idx.order[p];
                        if (dist2(idx, i, qx, qy, qz) > r2) continue;
                        if (check_elev &&
                            std::fabs(pe - gelev[i]) > max_diff)
                            continue;
                        out[i] = src ? src[i] : values[j];
                    }
                }
            }
        }
    }
}

void index_radius_count(void* h, const double* q, int64_t nq, double radius,
                        int32_t* out_count) {
    const Index& idx = *(Index*)h;
    double r2 = radius * radius;
    parallel_for(nq, [&](int64_t s, int64_t e) {
        for (int64_t j = s; j < e; j++) {
            double qx = q[3 * j], qy = q[3 * j + 1], qz = q[3 * j + 2];
            int64_t c0x, c0y, c0z, c1x, c1y, c1z;
            idx.cell_of(qx - radius, qy - radius, qz - radius, c0x, c0y, c0z);
            idx.cell_of(qx + radius, qy + radius, qz + radius, c1x, c1y, c1z);
            c0x = std::max(c0x, idx.c0[0]); c1x = std::min(c1x, idx.c1[0]);
            c0y = std::max(c0y, idx.c0[1]); c1y = std::min(c1y, idx.c1[1]);
            c0z = std::max(c0z, idx.c0[2]); c1z = std::min(c1z, idx.c1[2]);
            int32_t count = 0;
            for (int64_t ix = c0x; ix <= c1x; ix++) {
                for (int64_t iy = c0y; iy <= c1y; iy++) {
                    for (int64_t iz = c0z; iz <= c1z; iz++) {
                        auto it = idx.cells.find(idx.key(ix, iy, iz));
                        if (it == idx.cells.end()) continue;
                        for (int32_t p = it->second.first;
                             p < it->second.second; p++) {
                            if (dist2(idx, idx.order[p], qx, qy, qz) <= r2)
                                count++;
                        }
                    }
                }
            }
            out_count[j] = count;
        }
    });
}

// Fused radius query + statistic (reference src/api/gridding.cpp:6-61:
// per-cell radius query then calc_statistic). One pass per query cell:
// walk the covering cells, accumulate (Mean/Sum/Count/Std/Variance) or
// gather+sort (Min/Max/Median/Quantile with order-statistic
// interpolation, util.cpp:111-178 semantics). min_num gates on the RAW
// in-radius count; the statistic itself skips non-finite values.
// stat codes match constants.py Statistic.
void index_radius_stat(void* h, const double* q, int64_t nq, double radius,
                       const float* values, int32_t stat, double quantile,
                       int64_t min_num, float* out) {
    const Index& idx = *(Index*)h;
    const double r2 = radius * radius;
    const float nanf = std::numeric_limits<float>::quiet_NaN();
    // Statistic codes from constants.py / gridpp.h:89-101
    enum { kMean = 0, kMin = 10, kMedian = 20, kMax = 30, kQuantile = 40,
           kStd = 50, kVariance = 60, kSum = 70, kCount = 80 };
    const bool order_stat = (stat == kMin || stat == kMax ||
                             stat == kMedian || stat == kQuantile);
    double qv = quantile;
    if (stat == kMin) qv = 0.0;
    else if (stat == kMax) qv = 1.0;
    else if (stat == kMedian) qv = 0.5;

    parallel_for(nq, [&](int64_t s, int64_t e) {
        std::vector<float> buf;
        for (int64_t j = s; j < e; j++) {
            double qx = q[3 * j], qy = q[3 * j + 1], qz = q[3 * j + 2];
            int64_t c0x, c0y, c0z, c1x, c1y, c1z;
            idx.cell_of(qx - radius, qy - radius, qz - radius,
                        c0x, c0y, c0z);
            idx.cell_of(qx + radius, qy + radius, qz + radius,
                        c1x, c1y, c1z);
            c0x = std::max(c0x, idx.c0[0]); c1x = std::min(c1x, idx.c1[0]);
            c0y = std::max(c0y, idx.c0[1]); c1y = std::min(c1y, idx.c1[1]);
            c0z = std::max(c0z, idx.c0[2]); c1z = std::min(c1z, idx.c1[2]);
            int64_t nraw = 0, cnt = 0;
            double acc = 0, acc2 = 0;
            buf.clear();
            for (int64_t ix = c0x; ix <= c1x; ix++) {
                for (int64_t iy = c0y; iy <= c1y; iy++) {
                    for (int64_t iz = c0z; iz <= c1z; iz++) {
                        auto it = idx.cells.find(idx.key(ix, iy, iz));
                        if (it == idx.cells.end()) continue;
                        for (int32_t p = it->second.first;
                             p < it->second.second; p++) {
                            int32_t i = idx.order[p];
                            if (dist2(idx, i, qx, qy, qz) > r2) continue;
                            nraw++;
                            float v = values[i];
                            if (!std::isfinite(v)) continue;
                            cnt++;
                            if (order_stat) {
                                buf.push_back(v);
                            } else {
                                acc += v;
                                if (stat == kStd || stat == kVariance)
                                    acc2 += (double)v * v;
                            }
                        }
                    }
                }
            }
            float o = nanf;
            if (min_num > 0 && nraw < min_num) {
                out[j] = nanf;  // gated regardless of statistic
                continue;
            }
            if (stat == kCount) {
                o = (float)cnt;
            } else if (cnt > 0) {
                if (stat == kSum) {
                    o = (float)acc;
                } else if (stat == kMean) {
                    o = (float)(acc / (double)cnt);
                } else if (stat == kStd || stat == kVariance) {
                    double c = (double)cnt;
                    double var = acc2 / c - (acc / c) * (acc / c);
                    if (var < 0) var = 0;
                    o = (float)(stat == kStd ? std::sqrt(var) : var);
                } else {  // order statistics with linear interpolation
                    std::sort(buf.begin(), buf.end());
                    double qn = qv * (double)(cnt - 1);
                    int64_t lo = (int64_t)std::floor(qn);
                    int64_t hi = (int64_t)std::ceil(qn);
                    double lv = buf[std::min<int64_t>(lo, cnt - 1)];
                    double uv = buf[std::min<int64_t>(hi, cnt - 1)];
                    double f = hi > lo ? (qn - (double)lo) /
                                             (double)(hi - lo) : 0.0;
                    o = (float)(lv + (uv - lv) * f);
                }
            }
            out[j] = o;
        }
    });
}

}  // extern "C"
