"""Throughput benchmark harness (counterpart of the reference's
tests/benchmark.py expected-runtime table).

Runs every headline operator at the reference's benchmark sizes and
compares measured wall time against the reference's published expected
times (Intel i7 3.40 GHz, 1 OpenMP thread — tests/benchmark.py:52-83 in
the reference). Timings are steady-state: one warm-up call first (jit
compile + host precompute caches), then the median of -n iterations,
including host<->device transfers (honest end-to-end numpy API cost).

Not collected by pytest (no test_ prefix); run directly:

    python tests/benchmark.py [-t neighbourhood oi ...] [-n 3] [-s 0.5]
"""
import argparse
import collections
import json
import os
import sys
import time

import numpy as np

# Runnable as `python tests/benchmark.py` from any CWD, without an install.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_grid(n, scaling=1.0, lat0=50.0, lon0=5.0, dlat=5.0):
    import gridpp_tpu as gridpp
    n = int(n * scaling)
    lats, lons = np.meshgrid(np.linspace(lat0, lat0 + dlat, n),
                             np.linspace(lon0, lon0 + dlat, n),
                             indexing="ij")
    return gridpp.Grid(lats, lons, np.zeros((n, n)), np.zeros((n, n)))


def build_points(num, scaling=1.0, lat0=50.0, lon0=5.0, dlat=5.0, seed=0):
    import gridpp_tpu as gridpp
    num = int(num * scaling)
    rng = np.random.default_rng(seed)
    return gridpp.Points(rng.uniform(lat0, lat0 + dlat, num),
                         rng.uniform(lon0, lon0 + dlat, num),
                         np.zeros(num), np.zeros(num))


def main():
    parser = argparse.ArgumentParser(
        description="gridpp_tpu throughput benchmarks")
    parser.add_argument("-s", type=float, default=1.0, dest="scaling",
                        help="scale problem sizes by this factor")
    parser.add_argument("-n", type=int, default=3, dest="iterations",
                        help="iterations to take the median over")
    parser.add_argument("-t", dest="functions", nargs="*",
                        help="run only benchmarks whose name contains any "
                             "of these substrings")
    args = parser.parse_args()
    s = args.scaling

    import jax
    import gridpp_tpu as gridpp
    # The parity API is host-pinned (XLA:CPU); warm that backend up.
    np.asarray(jax.device_put(np.ones(1), jax.devices("cpu")[0]))

    rng = np.random.default_rng(1000)
    radius = 7
    quantile = 0.5
    thresholds = np.linspace(0, 1, 11)
    structure = gridpp.BarnesStructure(10000)

    # Lazy input builders, so skipped benchmarks cost nothing.
    def I(*shape):
        return rng.random([int(shape[0] * s)] + list(shape[1:]),
                          np.float32)

    run = collections.OrderedDict()

    def add(name, detail, expected, make_args, func=None):
        run[(name, detail)] = {
            "expected": expected,
            "make_args": make_args,
            "func": func or getattr(gridpp, name),
        }

    add("Grid", "1000²", 0.74,
        lambda: (np.meshgrid(np.linspace(50, 55, int(1000 * s)),
                             np.linspace(5, 10, int(1000 * s)),
                             indexing="ij")),
        func=lambda la, lo: gridpp.Grid(la, lo))
    add("neighbourhood", "10000² mean", 2.05,
        lambda: (np.zeros([int(10000 * s), int(10000 * s)], np.float32),
                 radius, gridpp.Mean))
    add("neighbourhood", "2000² max", 0.99,
        lambda: (I(2000, int(2000 * s)), radius, gridpp.Max))
    add("neighbourhood_quantile_fast", "2000²", 1.23,
        lambda: (I(2000, int(2000 * s)), quantile, radius, thresholds))
    add("neighbourhood_quantile", "500²", 1.70,
        lambda: (I(500, int(500 * s)), quantile, radius))
    add("bilinear", "1000²", 1.68,
        lambda: (build_grid(1000, s), build_grid(1000, s),
                 I(1000, int(1000 * s))))
    add("bilinear", "1000² x 50", 4.42,
        lambda: (build_grid(1000, s), build_grid(1000, s),
                 I(50, int(1000 * s), int(1000 * s))))
    add("nearest", "1000²", 1.52,
        lambda: (build_grid(1000, s), build_grid(1000, s),
                 I(1000, int(1000 * s))))
    add("nearest", "1000² x 50", 1.93,
        lambda: (build_grid(1000, s), build_grid(1000, s),
                 I(50, int(1000 * s), int(1000 * s))))
    add("gridding", "200² 100000", 0.61,
        lambda: (build_grid(200, s), build_points(100000, s),
                 np.zeros(int(100000 * s), np.float32), 5000, 1,
                 gridpp.Mean))
    add("gridding_nearest", "200² 100000", 0.11,
        lambda: (build_grid(200, s), build_points(100000, s),
                 np.zeros(int(100000 * s), np.float32), 1, gridpp.Mean))
    add("optimal_interpolation", "100² 1000", 0.80,
        lambda: (build_grid(100, s), I(100, int(100 * s)),
                 build_points(1000, s), np.zeros(int(1000 * s)),
                 np.ones(int(1000 * s)), np.ones(int(1000 * s)),
                 structure, 20))
    def spatial_structure():
        n = int(100 * s)
        lats, lons = np.meshgrid(np.linspace(50, 55, n),
                                 np.linspace(5, 10, n), indexing="ij")
        sgrid = gridpp.Grid(lats, lons)
        h = np.full((n, n), 10000.0, np.float32)
        v = np.full((n, n), 200.0, np.float32)
        return gridpp.BarnesStructure(sgrid, h, v, np.zeros((n, n)))

    add("optimal_interpolation", "100² 1000 spatial-h", 0.91,
        lambda: (build_grid(100, s), I(100, int(100 * s)),
                 build_points(1000, s), np.zeros(int(1000 * s)),
                 np.ones(int(1000 * s)), np.ones(int(1000 * s)),
                 spatial_structure(), 20))
    add("optimal_interpolation", "2000² 10000", None,
        lambda: (build_grid(2000, s), I(2000, int(2000 * s)),
                 build_points(10000, s), np.zeros(int(10000 * s)),
                 np.ones(int(10000 * s)), np.ones(int(10000 * s)),
                 structure, 10))
    add("dewpoint", "1e7", 0.53,
        lambda: (np.zeros(int(1e7 * s), np.float32) + 273.15,
                 np.zeros(int(1e7 * s), np.float32)))
    add("fill", "1e5", 1.96,
        lambda: (build_grid(200, s),
                 np.zeros([int(200 * s), int(200 * s)], np.float32),
                 build_points(100000, s),
                 np.ones(int(100000 * s)) * 5000, 1, False))
    add("doping_square", "1e5", 0.12,
        lambda: (build_grid(200, s),
                 np.zeros([int(200 * s), int(200 * s)], np.float32),
                 build_points(100000, s), np.ones(int(100000 * s)),
                 np.ones(int(100000 * s), "int") * 5, False))
    add("doping_circle", "1e5", 2.00,
        lambda: (build_grid(200, s),
                 np.zeros([int(200 * s), int(200 * s)], np.float32),
                 build_points(100000, s), np.ones(int(100000 * s)),
                 np.ones(int(100000 * s)) * 5000, False))
    add("local_distribution_correction", "200² 1000", 1.31,
        lambda: (build_grid(200, s),
                 np.zeros([int(200 * s), int(200 * s)], np.float32),
                 build_points(1000, s), np.ones(int(1000 * s)),
                 np.ones(int(1000 * s)), structure, 0.1, 0.9, 5))
    add("full_gradient", "1000²", 1.59,
        lambda: (build_grid(1000, s), build_grid(1000, s),
                 I(1000, int(1000 * s)), I(1000, int(1000 * s)),
                 I(1000, int(1000 * s))))
    add("calc_gradient", "2000²", 0.45,
        lambda: (rng.random([int(2000 * s), int(2000 * s)],
                            np.float32) * 100,
                 np.zeros([int(2000 * s), int(2000 * s)], np.float32),
                 gridpp.LinearRegression, 10, 0, 100, 0))
    add("mask_threshold_downscale_consensus", "100²→1000²", 0.91,
        lambda: (build_grid(100, s), build_grid(1000, s),
                 I(100, int(100 * s), 10), I(100, int(100 * s), 10),
                 I(100, int(100 * s), 10),
                 rng.random([int(1000 * s), int(1000 * s)], np.float32),
                 gridpp.Lt, gridpp.Mean))
    add("neighbourhood_search", "2000² 7x7", 1.11,
        lambda: (I(2000, int(2000 * s)), I(2000, int(2000 * s)),
                 3, 0.7, 1.0, 0.1,
                 rng.random([int(2000 * s), int(2000 * s)]) < 0.5))
    add("window", "100000x1000", 1.67,
        lambda: (I(100000, 1000), 101, gridpp.Mean, False, False))
    add("gamma_inv", "5*201*476", 1.168,
        lambda: (rng.random(int(5 * 201 * 476 * s)) * 0.9 + 0.05,
                 rng.random(int(5 * 201 * 476 * s)) + 0.5,
                 rng.random(int(5 * 201 * 476 * s)) + 0.5))
    add("apply_curve", "2000²", 0.06,
        lambda: (I(2000, int(2000 * s)), np.sort(rng.random(2000)),
                 np.sort(rng.random(2000)), gridpp.OneToOne,
                 gridpp.OneToOne))
    add("apply_curve", "2000² gridded curves", 0.87,
        lambda: (I(2000, int(2000 * s)),
                 np.sort(rng.random([int(2000 * s), int(2000 * s), 5],
                                    np.float32), axis=-1),
                 np.sort(rng.random([int(2000 * s), int(2000 * s), 5],
                                    np.float32), axis=-1),
                 gridpp.OneToOne, gridpp.OneToOne))
    add("get_optimal_threshold", "1e6", 0.38,
        lambda: (rng.standard_normal(int(1e6 * s)).astype(np.float32),
                 rng.standard_normal(int(1e6 * s)).astype(np.float32),
                 0.0, gridpp.Ets))

    print("gridpp_tpu benchmark (version %s) on %s" %
          (gridpp.version(), jax.devices()[0].platform))
    print("Reference expected times: Intel i7 3.40 GHz, 1 OMP thread")
    print("Execution model: numpy-in/numpy-out API; most per-op rows run")
    print("on XLA:CPU + threaded C++ host kernels. Device-resident serving")
    print("perf is measured by bench.py, not this table.")
    print("-" * 78)
    print("%-44s %9s %9s %9s" % ("Function", "Ref(s)", "measured(s)",
                                 "Speedup"))

    results = []
    total_ref = 0.0
    total_ours = 0.0
    for (name, detail), spec in run.items():
        label = "%s %s" % (name, detail)
        if args.functions and not any(t in label
                                      for t in args.functions):
            continue
        try:
            call_args = spec["make_args"]()
            func = spec["func"]
            func(*call_args)  # warm-up: compile + precompute caches
            times = []
            for _ in range(args.iterations):
                t0 = time.perf_counter()
                func(*call_args)
                times.append(time.perf_counter() - t0)
            t = float(np.median(times))
        except Exception as e:  # keep the table going
            print("%-44s %9s %9s %9s  (%s)" %
                  (label, "-", "FAIL", "-", type(e).__name__))
            continue
        exp = spec["expected"]
        speed = (exp / t) if exp else float("nan")
        print("%-44s %9s %9.4f %8.1fx" %
              (label, ("%.2f" % exp) if exp else "-", t, speed))
        results.append({"name": label, "expected_s": exp,
                        "measured_s": t,
                        "speedup": None if exp is None else speed})
        if exp:
            total_ref += exp
            total_ours += t
    print("-" * 78)
    if total_ours > 0:
        print("%-44s %9.2f %9.4f %8.1fx" %
              ("TOTAL (entries with reference numbers)", total_ref,
               total_ours, total_ref / total_ours))
    print(json.dumps({"benchmarks": results}))


if __name__ == "__main__":
    main()
