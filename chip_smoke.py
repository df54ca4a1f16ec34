#!/usr/bin/env python3
"""Chip smoke: drive the analysis cycle once on an NVIDIA GPU and check it.

    python chip_smoke.py          one card: phases 1-5 below
    python chip_smoke.py --four   four cards: the sharded pipeline step on
                                  a 2x2 mesh against the same step on a
                                  one-card mesh, and nothing else

Phases (one process, one card):
  1. device gate: nvidia-smi's name and power limit (from a child process
     that never imports JAX), jax.devices(), and a refusal of anything
     but a GPU;
  2. Pipeline at the north-star size (2000^2 grid, 10k obs,
     BarnesStructure(10000), h=7 Mean, max_points=10): the fast, general
     and resolve paths, 3 cycles of serve_stream, and the one-hot paging
     against a plain gather, all against the host API
     (gridpp.neighbourhood + gridpp.optimal_interpolation);
  3. EnsiPipeline and MultiEnsiPipeline (ebesc/ebe/utem), E=10, against
     their host API at 500^2 with the same observation density, then the
     2000^2 cycle on the card;
  4. device ops: ops.neighbourhood for every statistic and
     neighbourhood_quantile_fast (T=11) on a 2000^2 device array against
     the host API, with XLA's stencil times against their byte roofline;
  5. the public API sweep: every public function called once.

Every comparison states its tolerance; the default is the dense-parity
contract max|d| < 1e-2 K at every gridpoint, float32, under the
program's own precision settings. The last stdout line is one JSON
object {"ok": true, "device": {...}}; a phase that fails or misses its
tolerance makes the script exit non-zero without it, and so does a run
with no GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

TOL = 1e-2  # K, the dense-parity contract (tests/test_parity_dense.py)
BIG = 1e-3  # gridpoints above this |d| are counted and reported
# The north-star problem of bench.py: h=7 Mean, 10 observations per
# gridpoint, 3 served cycles, 11 quantile_fast thresholds
HALFWIDTH = 7
MAX_POINTS = 10
CYCLES = 3
N_THRESHOLDS = 11


# --- measurement helpers -------------------------------------------------
class CompileMeter:
    """Seconds JAX spent tracing, lowering and compiling, and persistent
    cache hits/misses, since the last take()."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.secs = 0.0
        self.hits = 0
        self.misses = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, secs, **_):
        if event in self._EVENTS:
            self.secs += secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def take(self):
        out = {"compile_s": round(self.secs, 3), "cache_hits": self.hits,
               "cache_misses": self.misses}
        self.secs, self.hits, self.misses = 0.0, 0, 0
        return out


def compare(got, want, tol=TOL):
    """max|got - want| and the count of gridpoints above BIG; NaN must
    sit exactly where the reference has NaN."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return {"ok": False, "why": f"shape {got.shape} != {want.shape}"}
    nan_ok = bool(np.array_equal(np.isnan(got), np.isnan(want)))
    fin = np.isfinite(want)
    d = np.abs(got[fin] - want[fin]) if fin.any() else np.zeros(1)
    d = np.where(np.isnan(d), np.inf, d)
    mx = float(d.max()) if d.size else 0.0
    return {"ok": nan_ok and mx < tol, "max_abs": mx,
            "n_over_1e-3": int((d > BIG).sum()), "tol": tol,
            "nan_match": nan_ok}


def warm_seconds(fn, reps=3):
    """Mean seconds of one call, after a warm call, ending each call in
    block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def memory_summary(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


# --- problems ------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def problem(n, n_obs, seed=0):
    """The bench.py problem scaled to an n x n grid: lat/lon spacing of
    the 2000^2 grid over 7 degrees, n_obs uniform observations in the
    same box, BarnesStructure(10000). Cached, so that phases on the same
    problem share its host precompute (shortlists, tile tables)."""
    import gridpp_tpu as gridpp
    span = 7.0 * n / 2000
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 55 + span, n),
                             np.linspace(5, 5 + span, n), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    points = gridpp.Points(rng.uniform(55, 55 + span, n_obs),
                           rng.uniform(5, 5 + span, n_obs),
                           np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    idx = grid.nearest_map(points.lats, points.lons, cache_obj=points)
    pobs = (background.reshape(-1)[idx]
            + rng.normal(0, 1, n_obs)).astype(np.float32)
    return {"grid": grid, "points": points, "background": background,
            "pobs": pobs, "ratios": np.full(n_obs, 0.1, np.float32),
            "structure": gridpp.BarnesStructure(10000.0), "idx": idx,
            "rng": rng}


# --- phase 2 -------------------------------------------------------------
def check_paging(pipe):
    """The tiled sweep pages candidate rows with a one-hot matmul
    (ops.oi_tiled.page_rows, precision (DEFAULT, HIGHEST)). Paging must
    be an exact pick: compare it bit for bit with a plain gather on the
    Pipeline's real tile geometry and full-mantissa f32 values."""
    import jax.numpy as jnp
    from gridpp_tpu.ops.oi_tiled import page_rows
    li = pipe._geom_dev["local_idx"][:16]               # (N, tb, K)
    c_cap = int(pipe._geom.c_cap)
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(280, 5, (li.shape[0], c_cap, 8))
                        .astype(np.float32))
    paged = np.asarray(page_rows(li, table))
    gathered = np.asarray(jnp.take_along_axis(
        table[:, None, :, :], li[..., None].astype(jnp.int32), axis=2))
    return {"ok": bool(np.array_equal(paged, gathered)),
            "max_abs": float(np.abs(paged - gathered).max()),
            "tol": "bit-exact"}


def check_pipeline(n=2000, n_obs=10000, meter=None):
    """Phase 2. Returns (rows, resolve_warm_s)."""
    import jax.numpy as jnp
    import gridpp_tpu as gridpp

    meter = meter or CompileMeter()
    p = problem(n, n_obs)
    grid, points, structure = p["grid"], p["points"], p["structure"]
    bg, pobs, ratios = p["background"], p["pobs"], p["ratios"]
    rows = []

    t0 = time.perf_counter()
    smoothed = gridpp.neighbourhood(bg, HALFWIDTH, gridpp.Mean)
    pback = smoothed.reshape(-1)[p["idx"]]
    want = gridpp.optimal_interpolation(grid, smoothed, points, pobs,
                                        ratios, pback, structure,
                                        MAX_POINTS)
    rows.append(("host reference", {"host_s": round(
        time.perf_counter() - t0, 3), **meter.take()}))

    t0 = time.perf_counter()
    pipe = gridpp.Pipeline(grid, points, structure, halfwidth=HALFWIDTH,
                           statistic=gridpp.Mean, max_points=MAX_POINTS,
                           ratios=ratios, tiled=True)
    rows.append(("Pipeline setup", {"setup_s": round(
        time.perf_counter() - t0, 3), **meter.take()}))

    bg_d, pobs_d = jnp.asarray(bg), jnp.asarray(pobs)
    resolve_s = None
    for path in ("fast", "general", "resolve"):
        def run(path=path):
            if path == "fast":
                return pipe.run_device(bg_d, pobs_d, assume_valid=True,
                                       path="fast")
            return pipe.run_device(bg_d, pobs_d, path=path)
        t0 = time.perf_counter()
        out = np.asarray(run())
        first = time.perf_counter() - t0
        comp = meter.take()
        warm = warm_seconds(run)
        if path == "resolve":
            resolve_s = warm
        rows.append((f"run_device path={path}", {
            **compare(out, want), "first_call_s": round(first, 3),
            **comp, "warm_s": warm, "peak_bytes_in_use": peak_bytes()}))

    for path in ("fast", "resolve"):
        compiled = pipe.lower(bg_d, pobs_d, path=path).compile()
        rows.append((f"memory_analysis path={path}",
                     {"ok": True, **(memory_summary(compiled) or {}),
                      **meter.take()}))

    rows.append(("one-hot paging vs gather", check_paging(pipe)))

    host_cycles = [(bg + np.float32(i), pobs + np.float32(i))
                   for i in range(CYCLES)]
    t0 = time.perf_counter()
    served = list(pipe.serve_stream(host_cycles))
    serve_s = time.perf_counter() - t0
    same = all(np.array_equal(s, np.asarray(pipe.run_device(
        jnp.asarray(b), jnp.asarray(o), assume_valid=True)))
        for s, (b, o) in zip(served, host_cycles))
    rows.append((f"serve_stream {CYCLES} cycles", {
        **compare(served[0], want), "ok": compare(served[0], want)["ok"]
        and same and len(served) == CYCLES,
        "equal_to_run_device": same, "seconds": round(serve_s, 3),
        **meter.take()}))
    return rows, resolve_s


# --- phase 3 -------------------------------------------------------------
def _ensemble_inputs(p, e):
    rng = p["rng"]
    bg = p["background"]
    n_obs = p["points"].size()
    bg3 = (bg[:, :, None] + rng.normal(0, 1, bg.shape + (e,))
           ).astype(np.float32)
    bgc = (bg[:, :, None] + rng.normal(0, 1, bg.shape + (e,))
           ).astype(np.float32)
    pb3 = bg3.reshape(-1, e)[p["idx"]]
    pbc = bgc.reshape(-1, e)[p["idx"]]
    pobs_e = (pb3 + rng.normal(0, 1, (n_obs, e))).astype(np.float32)
    return bg3, bgc, pb3, pbc, pobs_e


def _ensemble_runs(p, e, max_points):
    """(name, device thunk, host-reference thunk) for the four schemes."""
    import jax.numpy as jnp
    import gridpp_tpu as gridpp
    grid, pts, st = p["grid"], p["points"], p["structure"]
    pobs, ratios = p["pobs"], p["ratios"]
    n_obs = pts.size()
    bg3, bgc, pb3, pbc, pobs_e = _ensemble_inputs(p, e)
    psig = np.full(n_obs, 1.5, np.float32)
    bratios = np.ones(grid.size()[0] * grid.size()[1], np.float32)
    d = {k: jnp.asarray(v) for k, v in dict(
        bg3=bg3, bgc=bgc, pobs=pobs, pobs_e=pobs_e, psig=psig,
        ratios=ratios).items()}
    runs = []

    epipe = gridpp.EnsiPipeline(grid, pts, st, max_points=max_points)
    runs.append(("EnsiPipeline", lambda: epipe.run_device(
        d["bg3"], d["pobs"], d["psig"], assume_valid=True),
        lambda: gridpp.optimal_interpolation_ensi(
            grid, bg3, pts, pobs, psig, pb3, st, max_points)))
    for variant in ("ebesc", "ebe", "utem"):
        mp = gridpp.MultiEnsiPipeline(grid, pts, st, variant=variant,
                                      max_points=max_points)
        if variant == "ebesc":
            dev = (lambda mp=mp: mp.run_device(d["bg3"], d["pobs_e"],
                                               d["ratios"]))
            host = (lambda: gridpp.optimal_interpolation_ensi_multi_ebesc(
                grid, bratios, bg3, pts, pobs_e, ratios, pb3, st,
                max_points))
        elif variant == "ebe":
            dev = (lambda mp=mp: mp.run_device(
                d["bg3"], d["pobs_e"], d["ratios"], background_corr=d["bgc"]))
            host = (lambda: gridpp.optimal_interpolation_ensi_multi_ebe(
                grid, bratios, bg3, bgc, pts, pobs_e, ratios, pb3, pbc, st,
                max_points))
        else:
            dev = (lambda mp=mp: mp.run_device(
                d["bg3"], d["pobs"], d["ratios"], background_corr=d["bgc"]))
            host = (lambda: gridpp.optimal_interpolation_ensi_multi_utem(
                grid, bratios, bg3, bgc, pts, pobs, ratios, pb3, pbc, st,
                max_points))
        runs.append((f"MultiEnsiPipeline {variant}", dev, host))
    return runs


def check_ensemble(n=500, n_obs=625, e=10, max_points=MAX_POINTS,
                   meter=None):
    """Phase 3a: every ensemble scheme against its host API function.
    Newton-Schulz (EnSI, utem) blowing up at any gridpoint fails the
    max|d| bound."""
    meter = meter or CompileMeter()
    p = problem(n, n_obs, seed=1)
    rows = []
    for name, dev, host in _ensemble_runs(p, e, max_points):
        t0 = time.perf_counter()
        out, n_bad = dev()
        out = np.asarray(out)
        first = time.perf_counter() - t0
        comp = meter.take()
        warm = warm_seconds(dev)
        t0 = time.perf_counter()
        want = host()
        host_s = time.perf_counter() - t0
        rows.append((f"{name} {n}^2 E={e}", {
            **compare(out, want), "first_call_s": round(first, 3), **comp,
            "warm_s": warm, "host_s": round(host_s, 3),
            "host_compile_s": meter.take()["compile_s"],
            "cond_failures": int(n_bad),
            "peak_bytes_in_use": peak_bytes()}))
    return rows


def check_ensemble_full(n=2000, n_obs=10000, e=10, meter=None):
    """Phase 3b: the ensemble cycles at the north-star size on the card:
    finite, of the expected shape, and within memory."""
    meter = meter or CompileMeter()
    p = problem(n, n_obs)
    rows = []
    for name, dev, _host in _ensemble_runs(p, e, MAX_POINTS):
        t0 = time.perf_counter()
        out, n_bad = dev()
        out = np.asarray(out)
        first = time.perf_counter() - t0
        comp = meter.take()
        warm = warm_seconds(dev, reps=2)
        ok = out.shape == (n, n, e) and bool(np.isfinite(out).all())
        rows.append((f"{name} {n}^2 E={e}", {
            "ok": ok, "finite": bool(np.isfinite(out).all()),
            "first_call_s": round(first, 3), **comp, "warm_s": warm,
            "cond_failures": int(n_bad),
            "peak_bytes_in_use": peak_bytes()}))
    return rows


# --- phase 4 -------------------------------------------------------------
# Looser bounds, each with its reason. Sum: window sums of ~280 K over
# (2h+1)^2 cells reach ~6e4, and the device's separable tree sums and the
# host's running sums round in another order: 1e-6 relative. Variance:
# E[x^2] - E[x]^2 in float32 (the reference's own formula) cancels ~9e4
# against ~9e4, so each side carries up to ~16 float32 ulp of E[x^2]:
# 2e-6 relative to max x^2. Std inherits that bound through
# d sqrt(v) = dv / (2 sqrt(v)) at the smallest standard deviation.
def _stat_tol(stat, want, x):
    from gridpp_tpu.constants import Statistic
    if stat == Statistic.Sum:
        return max(TOL, 1e-6 * float(np.nanmax(np.abs(want))))
    var_tol = 2e-6 * float(np.nanmax(x.astype(np.float64) ** 2))
    if stat == Statistic.Variance:
        return max(TOL, var_tol)
    if stat == Statistic.Std:
        return max(TOL, var_tol / (2 * float(np.nanmin(want[want > 0]))))
    return TOL


def _ops_input(n):
    """An n x n f32 field near 280 K with 1 % NaN cells."""
    rng = np.random.default_rng(4)
    x = rng.normal(280, 5, (n, n)).astype(np.float32)
    x[rng.random((n, n)) < 0.01] = np.nan
    return x


def check_device_ops(n=2000, meter=None):
    """Phase 4a: device ops against the host API."""
    import jax.numpy as jnp
    import gridpp_tpu as gridpp
    from gridpp_tpu.constants import Statistic
    from gridpp_tpu.ops import neighbourhood as nops

    meter = meter or CompileMeter()
    x = _ops_input(n)
    xd = jnp.asarray(x)
    rows = []
    for stat in (Statistic.Mean, Statistic.Sum, Statistic.Count,
                 Statistic.Min, Statistic.Max, Statistic.Std,
                 Statistic.Variance, Statistic.Median):
        out = np.asarray(nops.neighbourhood(xd, HALFWIDTH, int(stat)))
        comp = meter.take()
        want = gridpp.neighbourhood(x, HALFWIDTH, stat)
        rows.append((f"ops.neighbourhood {stat.name} {n}^2 h={HALFWIDTH}",
                     {**compare(out, want, _stat_tol(stat, want, x)),
                      **comp, "host_compile_s": meter.take()["compile_s"],
                      "peak_bytes_in_use": peak_bytes()}))
    thresholds = gridpp.get_neighbourhood_thresholds(x, N_THRESHOLDS)
    out = np.asarray(nops.neighbourhood_quantile_fast(
        xd, 0.5, HALFWIDTH, jnp.asarray(thresholds)))
    comp = meter.take()
    want = gridpp.neighbourhood_quantile_fast(x, 0.5, HALFWIDTH,
                                              thresholds)
    rows.append((f"neighbourhood_quantile_fast {n}^2 T={len(thresholds)}",
                 {**compare(out, want), **comp,
                  "host_compile_s": meter.take()["compile_s"],
                  "peak_bytes_in_use": peak_bytes()}))
    return rows


def check_stencil_times(n=2000, resolve_s=None):
    """Phase 4b: XLA's stencil times against their byte roofline and
    their share of the resolve cycle. The card must have a row in
    tools.roofline's peak table; an unknown card raises."""
    import jax.numpy as jnp
    import gridpp_tpu as gridpp
    from gridpp_tpu.constants import Statistic
    from gridpp_tpu.ops import neighbourhood as nops
    from tools.roofline import chip_peaks

    hbm = chip_peaks()["gbytes_s"] * 1e9
    field_bytes = 2 * n * n * 4  # minimum io: one f32 field in, one out
    x = _ops_input(n)
    xd = jnp.asarray(x)
    thr_d = jnp.asarray(gridpp.get_neighbourhood_thresholds(x, N_THRESHOLDS))
    timings = {
        f"mean h={HALFWIDTH}": lambda: nops.neighbourhood(
            xd, HALFWIDTH, int(Statistic.Mean)),
        f"quantile_fast T={thr_d.shape[0]}":
            lambda: nops.neighbourhood_quantile_fast(xd, 0.5, HALFWIDTH,
                                                     thr_d),
    }
    rows = []
    for name, fn in timings.items():
        t = warm_seconds(fn, reps=20)
        row = {"ok": True, "xla_s": t, "io_bytes": field_bytes,
               "roofline_s": field_bytes / hbm,
               "roofline_share": field_bytes / hbm / t}
        if resolve_s:
            row["share_of_resolve_cycle"] = t / resolve_s
        rows.append((f"XLA stencil {name} {n}^2", row))
    return rows


# --- phase 5 -------------------------------------------------------------
def build_registry(g, jnp):
    """One or more calls of every public function, on small inputs."""
    rng = np.random.default_rng(0)
    ny, nx = 16, 20
    lats, lons = np.meshgrid(np.linspace(55, 58, ny),
                             np.linspace(5, 8, nx), indexing="ij")
    elevs = rng.uniform(0, 500, (ny, nx)).astype(np.float32)
    lafs = rng.uniform(0, 1, (ny, nx)).astype(np.float32)
    grid = g.Grid(lats, lons, elevs, lafs)
    olats, olons = np.meshgrid(np.linspace(55.1, 57.9, 2 * ny),
                               np.linspace(5.1, 7.9, 2 * nx), indexing="ij")
    ogrid = g.Grid(olats, olons)
    npts = 12
    plats = rng.uniform(55.2, 57.8, npts)
    plons = rng.uniform(5.2, 7.8, npts)
    points = g.Points(plats, plons, rng.uniform(0, 400, npts),
                      rng.uniform(0, 1, npts))
    field = rng.normal(280, 5, (ny, nx)).astype(np.float32)
    field3 = rng.normal(280, 5, (ny, nx, 3)).astype(np.float32)
    pobs = rng.normal(280, 5, npts).astype(np.float32)
    ratios = np.full(npts, 0.1, np.float32)
    structure = g.BarnesStructure(50000.0, 100.0, 0.5)
    curve_x = np.linspace(270, 290, 9).astype(np.float32)
    curve_y = (curve_x + 1.5).astype(np.float32)
    thresholds = np.linspace(270, 290, 7).astype(np.float32)
    vec = rng.normal(0, 1, 20).astype(np.float32)
    ref_b = (rng.random(40) > 0.5).astype(np.float32) * 2
    fcst_b = ref_b + rng.normal(0, 0.5, 40).astype(np.float32)
    pback = g.nearest(grid, points, field)
    bg_ens = rng.normal(280, 5, (ny, nx, 4)).astype(np.float32)
    pbg_ens = np.stack([g.nearest(grid, points, bg_ens[:, :, e])
                        for e in range(4)], axis=1)
    bratios = np.full((ny, nx), 0.1, np.float32)

    def _pt(lat, lon):
        return g.Point(lat, lon, 0.0, 0.0)

    stats_all = [g.Mean, g.Min, g.Median, g.Max, g.Std, g.Variance,
                 g.Sum, g.Count]

    R = {}

    def reg(name, *thunks):
        R[name] = list(thunks)

    # --- core classes ---------------------------------------------------
    reg("Grid", lambda: grid.get_nearest_neighbour(56.0, 6.0),
        lambda: grid.to_points().size())
    reg("Points", lambda: points.get_closest_neighbours(56.0, 6.0, 3),
        lambda: points.subset([0, 1, 2]).size())
    reg("Point", lambda: _pt(56.0, 6.0).lat)
    reg("KDTree", lambda: g.KDTree(plats, plons).size())
    reg("BarnesStructure", lambda: structure.corr(_pt(56, 6), _pt(56, 6.1)))
    reg("CressmanStructure",
        lambda: g.CressmanStructure(5e4).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("SoarStructure",
        lambda: g.SoarStructure(5e4).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("ToarStructure",
        lambda: g.ToarStructure(5e4).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("PowerlawStructure",
        lambda: g.PowerlawStructure(5e4).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("LinearStructure",
        lambda: g.LinearStructure(1.0).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("MultipleStructure",
        lambda: g.MultipleStructure(
            g.BarnesStructure(5e4), g.BarnesStructure(5e4),
            g.BarnesStructure(5e4)).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("CrossValidation",
        lambda: g.CrossValidation(structure, 1000.0).corr_background(
            _pt(56, 6), _pt(56, 6.1)))
    reg("StructureFunction", lambda: structure.localization_distance)
    reg("Transform", lambda: g.Identity().forward(1.0))
    reg("Identity", lambda: g.Identity().backward(np.float32(2.0)))
    reg("Log", lambda: g.Log().backward(g.Log().forward(2.0)))
    reg("BoxCox", lambda: g.BoxCox(0.5).forward(field))
    reg("StartedBoxCox", lambda: g.StartedBoxCox(0.5, 1.0).forward(field))
    reg("Gamma", lambda: g.Gamma(2.0, 1.5).forward(np.float32(1.0)))

    # --- downscaling ----------------------------------------------------
    field_t3 = np.stack([field, field + 1, field + 2])  # vec3 = (T, Y, X)
    reg("nearest", lambda: g.nearest(grid, ogrid, field),
        lambda: g.nearest(grid, points, field_t3))
    reg("bilinear", lambda: g.bilinear(grid, ogrid, field))
    reg("downscaling", lambda: g.downscaling(grid, ogrid, field, g.Nearest),
        lambda: g.downscaling(grid, points, field, g.Bilinear))
    reg("simple_gradient",
        lambda: g.simple_gradient(grid, ogrid, field, -0.0065))
    reg("full_gradient",
        lambda: g.full_gradient(grid, ogrid, field, np.full(
            (ny, nx), -0.0065, np.float32)))
    reg("full_gradient_debug",
        lambda: g.full_gradient_debug(grid, ogrid, field, np.full(
            (ny, nx), -0.0065, np.float32)))
    reg("calc_gradient",
        lambda: g.calc_gradient(elevs, field, g.LinearRegression, 3),
        lambda: g.calc_gradient(elevs, field, g.MinMax, 3))
    reg("downscale_probability",
        lambda: g.downscale_probability(grid, ogrid, field3,
                                        np.full((2 * ny, 2 * nx), 280,
                                                np.float32), g.Gt))
    reg("mask_threshold_downscale_consensus",
        lambda: g.mask_threshold_downscale_consensus(
            grid, ogrid, field3, field3 + 1, field3,
            np.full((2 * ny, 2 * nx), 280, np.float32), g.Gt, g.Mean))
    reg("mask_threshold_downscale_quantile",
        lambda: g.mask_threshold_downscale_quantile(
            grid, ogrid, field3, field3 + 1, field3,
            np.full((2 * ny, 2 * nx), 280, np.float32), g.Gt, 0.5))

    # --- neighbourhood: every statistic, 2-D and 3-D --------------------
    reg("neighbourhood",
        *[(lambda s: lambda: g.neighbourhood(field, 3, s))(s)
          for s in stats_all],
        *[(lambda s: lambda: g.neighbourhood(field3, 3, s))(s)
          for s in stats_all],
        lambda: g.neighbourhood(field, 0, g.Mean))
    reg("neighbourhood_brute_force",
        lambda: g.neighbourhood_brute_force(field, 2, g.Mean),
        lambda: g.neighbourhood_brute_force(field3, 2, g.Max))
    reg("neighbourhood_ens",
        lambda: g.neighbourhood_ens(field3, 2, g.Mean))
    reg("neighbourhood_quantile",
        lambda: g.neighbourhood_quantile(field, 0.5, 2),
        lambda: g.neighbourhood_quantile(field3, 0.9, 2))
    reg("neighbourhood_quantile_ens",
        lambda: g.neighbourhood_quantile_ens(field3, 0.5, 2))
    reg("neighbourhood_quantile_fast",
        lambda: g.neighbourhood_quantile_fast(field, 0.5, 3, thresholds),
        lambda: g.neighbourhood_quantile_fast(field3, 0.5, 3, thresholds),
        lambda: g.neighbourhood_quantile_fast(
            field, np.full((ny, nx), 0.5, np.float32), 3, thresholds))
    reg("neighbourhood_quantile_ens_fast",
        lambda: g.neighbourhood_quantile_ens_fast(field3, 0.5, 2,
                                                  thresholds))
    reg("get_neighbourhood_thresholds",
        lambda: g.get_neighbourhood_thresholds(field, 11))
    reg("neighbourhood_search",
        lambda: g.neighbourhood_search(field, field, 2, 279, 281, 0.1))
    reg("window",
        lambda: g.window(field, 5, g.Mean, False, False, True),
        lambda: g.window(field, 4, g.Max, True, True, False))
    reg("neighbourhood_score",
        *[(lambda m: lambda: g.neighbourhood_score(
            grid, points, field, pobs, 3, m, 280.0))(m)
          for m in (g.Ets, g.Ts, g.Kss, g.Pc, g.Bias, g.Hss)])

    # --- calibration ----------------------------------------------------
    reg("apply_curve",
        lambda: g.apply_curve(field, curve_y, curve_x, g.OneToOne,
                              g.MeanSlope))
    reg("monotonize_curve", lambda: g.monotonize_curve(curve_y, curve_x))
    reg("quantile_mapping_curve",
        lambda: g.quantile_mapping_curve(vec, vec + 1))
    reg("metric_optimizer_curve",
        lambda: g.metric_optimizer_curve(ref_b, fcst_b,
                                         np.array([0.5, 1.5], np.float32),
                                         g.Ets))
    reg("get_optimal_threshold",
        lambda: g.get_optimal_threshold(ref_b, fcst_b, 1.0, g.Ets))
    reg("calc_score",
        lambda: g.calc_score(10.0, 3.0, 2.0, 25.0, g.Ets),
        lambda: g.calc_score(ref_b, fcst_b, 1.0, g.Pc))

    # --- OI family ------------------------------------------------------
    reg("optimal_interpolation",
        lambda: g.optimal_interpolation(grid, field, points, pobs, ratios,
                                        pback, structure, 5))
    reg("optimal_interpolation_full",
        lambda: g.optimal_interpolation_full(
            grid, field, np.ones((ny, nx), np.float32), points, pobs,
            np.full(npts, 0.1, np.float32), pback,
            np.ones(npts, np.float32), structure, 5))
    reg("optimal_interpolation_ensi",
        lambda: g.optimal_interpolation_ensi(
            grid, bg_ens, points, pobs, np.full(npts, 1.5, np.float32),
            pbg_ens, structure, 5))
    pobs_e = (pobs[:, None] + rng.normal(0, 0.5, (npts, 4))).astype(
        np.float32)  # perturbed obs (S, E)
    reg("optimal_interpolation_ensi_multi_ebe",
        lambda: g.optimal_interpolation_ensi_multi_ebe(
            grid, bratios, bg_ens, bg_ens, points, pobs_e, ratios, pbg_ens,
            pbg_ens, structure, 5))
    reg("optimal_interpolation_ensi_multi_ebesc",
        lambda: g.optimal_interpolation_ensi_multi_ebesc(
            grid, bratios, bg_ens, points, pobs_e, ratios, pbg_ens,
            structure, 5))
    reg("optimal_interpolation_ensi_multi_utem",
        lambda: g.optimal_interpolation_ensi_multi_utem(
            grid, bratios, bg_ens, bg_ens, points, pobs, ratios, pbg_ens,
            pbg_ens, structure, 5))  # utem takes pobs as vec (S,)
    reg("local_distribution_correction",
        lambda: g.local_distribution_correction(
            grid, np.abs(field - 275), points, np.abs(pobs - 275),
            np.abs(pback - 275), structure, 0.1, 0.9))
    reg("staticcorr_points",
        lambda: g.staticcorr_points(points, points, structure, 5))
    reg("smart", lambda: g.smart(grid, ogrid, field, 3, structure))

    # --- gridding / fill ------------------------------------------------
    reg("gridding",
        lambda: g.gridding(grid, points, pobs, 20000.0, 1, g.Mean))
    reg("gridding_nearest",
        lambda: g.gridding_nearest(grid, points, pobs, 1, g.Mean))
    reg("count", lambda: g.count(points, grid, 20000.0),
        lambda: g.count(grid, points, 20000.0))
    reg("distance", lambda: g.distance(grid, points, 1),
        lambda: g.distance(points, grid, 2))
    reg("fill",
        lambda: g.fill(grid, field, points, np.full(npts, 1e4, np.float32),
                       260.0, False))
    reg("fill_missing",
        lambda: g.fill_missing(np.where(field > 282, np.nan, field)))
    reg("doping_square",
        lambda: g.doping_square(grid, field, points, pobs,
                                np.ones(npts, np.int32)))
    reg("doping_circle",
        lambda: g.doping_circle(grid, field, points, pobs,
                                np.full(npts, 1e4, np.float32)))

    # --- diagnostics ----------------------------------------------------
    reg("dewpoint", lambda: g.dewpoint(283.0, 0.8),
        lambda: g.dewpoint(field, np.full_like(field, 0.8)))
    reg("relative_humidity", lambda: g.relative_humidity(283.0, 280.0))
    reg("wetbulb", lambda: g.wetbulb(283.0, 101325.0, 0.8))
    reg("pressure", lambda: g.pressure(100.0, 50.0, 101325.0, 288.0))
    reg("sea_level_pressure",
        lambda: g.sea_level_pressure(101325.0, 100.0, 288.0, 0.8))
    reg("qnh", lambda: g.qnh(101325.0, 100.0),
        lambda: g.qnh(np.full(3, 101325.0, np.float32),
                      np.full(3, 100.0, np.float32)))
    reg("wind_speed", lambda: g.wind_speed(3.0, 4.0),
        lambda: g.wind_speed(field, field))
    reg("wind_direction", lambda: g.wind_direction(3.0, 4.0))
    reg("gamma_inv", lambda: g.gamma_inv(0.5, 2.0, 1.5))

    # --- util -----------------------------------------------------------
    reg("calc_statistic",
        *[(lambda s: lambda: g.calc_statistic(vec, s))(s)
          for s in stats_all])
    reg("calc_quantile", lambda: g.calc_quantile(vec, 0.5),
        lambda: g.calc_quantile(field, 0.9))
    reg("calc_even_quantiles", lambda: g.calc_even_quantiles(vec, 5))
    reg("interpolate", lambda: g.interpolate(0.5, curve_x, curve_y))
    reg("get_lower_index", lambda: g.get_lower_index(275.0, curve_x))
    reg("get_upper_index", lambda: g.get_upper_index(275.0, curve_x))
    reg("compatible_size", lambda: g.compatible_size(field, field3))
    reg("convert_coordinates", lambda: g.convert_coordinates(plats, plons))
    reg("is_valid", lambda: g.is_valid(1.0) and not g.is_valid(np.nan))
    reg("is_valid_lat", lambda: g.is_valid_lat(56.0))
    reg("is_valid_lon", lambda: g.is_valid_lon(5.0))
    reg("num_missing_values",
        lambda: g.num_missing_values(np.where(field > 282, np.nan, field)))
    reg("point_in_rectangle",
        lambda: g.point_in_rectangle(_pt(0, 0), _pt(0, 1), _pt(1, 1),
                                     _pt(1, 0), _pt(0.5, 0.5)))
    reg("init_vec2", lambda: g.init_vec2(2, 3))
    reg("init_vec3", lambda: g.init_vec3(2, 3, 4, 1.0))
    reg("init_ivec2", lambda: g.init_ivec2(2, 3, 0))
    reg("init_ivec3", lambda: g.init_ivec3(2, 3, 4, 0))
    reg("get_statistic", lambda: g.get_statistic("mean"))
    reg("version", lambda: g.version())
    reg("clock", lambda: g.clock())
    reg("set_omp_threads", lambda: g.set_omp_threads(4))
    reg("get_omp_threads", lambda: g.get_omp_threads())
    reg("initialize_omp", lambda: g.initialize_omp())
    reg("set_debug_level", lambda: g.set_debug_level(0))
    reg("get_debug_level", lambda: g.get_debug_level())
    reg("KDTree_calc_distance",
        lambda: g.KDTree_calc_distance(56.0, 6.0, 56.1, 6.1))
    reg("KDTree_calc_distance_fast",
        lambda: g.KDTree_calc_distance_fast(56.0, 6.0, 56.1, 6.1))
    reg("KDTree_calc_straight_distance",
        lambda: g.KDTree_calc_straight_distance(_pt(56.0, 6.0),
                                                _pt(56.1, 6.1)),
        lambda: g.KDTree_calc_straight_distance(0.0, 0.0, 0.0,
                                                1.0, 2.0, 2.0))
    reg("KDTree_deg2rad", lambda: g.KDTree_deg2rad(180.0))
    reg("KDTree_rad2deg", lambda: g.KDTree_rad2deg(np.pi))

    # --- binding-parity shims -------------------------------------------
    reg("test_vec_input", lambda: g.test_vec_input(vec))
    reg("test_ivec_input", lambda: g.test_ivec_input([1, 2, 3]))
    reg("test_vec2_input", lambda: g.test_vec2_input(field))
    reg("test_vec3_input", lambda: g.test_vec3_input(field3))
    reg("test_vec_output", lambda: g.test_vec_output())
    reg("test_vec2_output", lambda: g.test_vec2_output())
    reg("test_vec3_output", lambda: g.test_vec3_output())
    reg("test_ivec_output", lambda: g.test_ivec_output())
    reg("test_ivec2_output", lambda: g.test_ivec2_output())
    reg("test_ivec3_output", lambda: g.test_ivec3_output())
    reg("test_vec_argout", lambda: g.test_vec_argout())
    reg("test_vec2_argout", lambda: g.test_vec2_argout())
    reg("test_array", lambda: g.test_array(vec))

    def _expect_raises(fn, exc):
        try:
            fn()
        except exc:
            return True
        raise AssertionError(f"expected {exc.__name__}")

    reg("test_not_implemented_exception",
        lambda: _expect_raises(g.test_not_implemented_exception,
                               NotImplementedError))
    reg("error", lambda: _expect_raises(lambda: g.error("smoke"),
                                        RuntimeError))
    reg("debug", lambda: g.debug("smoke"))
    reg("warning", lambda: g.warning("smoke"))
    reg("future_deprecation_warning",
        lambda: g.future_deprecation_warning("smoke"))

    # --- device entry points (compiled for the card) --------------------
    def _pipeline():
        import jax
        pipe = g.Pipeline(grid, points, structure, halfwidth=3,
                          statistic=g.Mean, max_points=5, ratios=ratios)
        out = jax.block_until_ready(
            pipe.run_device(jnp.asarray(field), jnp.asarray(pobs)))
        jax.block_until_ready(pipe.run_device(
            jnp.asarray(field), jnp.asarray(pobs), path="general"))
        return np.isfinite(np.asarray(out)).all()

    def _ensi_pipeline():
        import jax
        ep = g.EnsiPipeline(grid, points, structure, halfwidth=2,
                            max_points=5)
        out, _ = ep.run_device(jnp.asarray(bg_ens), jnp.asarray(pobs),
                               jnp.asarray(np.full(npts, 1.5, np.float32)))
        return np.isfinite(np.asarray(jax.block_until_ready(out))).all()

    def _multi_pipeline():
        import jax
        pratios_d = jnp.asarray(ratios)
        pobs_d = jnp.asarray(pobs_e)
        bg_d = jnp.asarray(bg_ens)
        for variant in ("ebesc", "utem", "ebe"):
            mp = g.MultiEnsiPipeline(grid, points, structure,
                                     variant=variant, max_points=5)
            ob = jnp.asarray(pobs) if variant == "utem" else pobs_d
            bc = None if variant == "ebesc" else bg_d
            out, _ = mp.run_device(bg_d, ob, pratios_d, background_corr=bc)
            jax.block_until_ready(out)
        return True

    reg("Pipeline", _pipeline)
    reg("EnsiPipeline", _ensi_pipeline)
    reg("MultiEnsiPipeline", _multi_pipeline)
    return R


# Public names with no standalone call: the enum families are IntEnums
# consumed as arguments by nearly every registered call above.
WAIVED = {
    "Statistic", "Metric", "Extrapolation", "CorrectionType",
    "CoordinateType", "GradientType", "Downscaler", "ComparisonOperator",
}


def check_public_api():
    """Phase 5: every public function and class called at least once."""
    import jax.numpy as jnp
    import gridpp_tpu as g
    registry = build_registry(g, jnp)
    public = {name for name, obj in vars(g).items()
              if not name.startswith("_")
              and isinstance(obj, (types.FunctionType, type))}
    uncovered = sorted(public - set(registry) - WAIVED)
    failures = []
    calls = 0
    for name in sorted(registry):
        for k, thunk in enumerate(registry[name]):
            calls += 1
            try:
                thunk()
            except Exception:  # each failure is reported, and fails the phase
                failures.append(f"{name}[{k}]: "
                                f"{traceback.format_exc(limit=4)}")
    return [("public API sweep", {
        "ok": not failures and not uncovered, "calls": calls,
        "functions": len(registry), "failures": failures,
        "uncovered": uncovered})]


# --- four cards ----------------------------------------------------------
def check_four(n=2000, n_obs=10000, e=10, meter=None):
    """The sharded step (halo stencil, sharded OI, sharded EnSI, the
    distributed step) on a 2x2 mesh of four cards against the same
    program on a one-card mesh."""
    import __graft_entry__ as ge
    from gridpp_tpu.parallel import make_mesh

    meter = meter or CompileMeter()
    # 1 km Cartesian spacing, Barnes 8 km: ~7 observations inside each
    # gridpoint's localization radius at 10k obs over 2000^2 km^2
    t0 = time.perf_counter()
    a = ge._pipeline_inputs(ny=n, nx=n, n_obs=n_obs, k=8, e=e,
                            length=8000.0)
    rows = [("sharded inputs", {"ok": True, "setup_s": round(
        time.perf_counter() - t0, 3), **meter.take()})]
    outs = {}
    for count in (4, 1):
        mesh = make_mesh(count)
        t0 = time.perf_counter()
        outs[count] = ge.sharded_step(mesh, a)
        rows.append((f"sharded_step mesh={dict(mesh.shape)}", {
            "ok": all(np.isfinite(v).all() for v in outs[count].values()),
            "first_call_s": round(time.perf_counter() - t0, 3),
            **meter.take(), "peak_bytes_in_use": peak_bytes()}))
    for key in outs[4]:
        cmp = compare(outs[4][key], outs[1][key])
        cmp["bit_identical"] = bool(np.array_equal(outs[4][key],
                                                   outs[1][key]))
        rows.append((f"2x2 mesh vs 1 card: {key}", cmp))
    return rows


# --- main ----------------------------------------------------------------
def _report(rows, label, failures):
    first_card = label.splitlines()[0] if label else "unknown card"
    for name, row in rows:
        ok = row.get("ok", True)
        if not ok:
            failures.append(name)
        fields = " ".join(f"{k}={v}" for k, v in row.items() if k != "ok")
        print(f"{'PASS' if ok else 'FAIL'} {name}: {fields} "
              f"[{first_card}]", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded step on four cards")
    opts = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import gridpp_tpu
        from gridpp_tpu import device as gdev
    except ImportError as e:
        print(f"chip_smoke: gridpp_tpu not importable from {HERE} ({e}); "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    if not os.path.dirname(os.path.abspath(gridpp_tpu.__file__)
                           ).startswith(HERE):
        print(f"chip_smoke: gridpp_tpu comes from {gridpp_tpu.__file__}, "
              f"not from this checkout ({HERE})", file=sys.stderr)
        return 2

    # Phase 1: the card's name and power limit come from a child process
    # before JAX touches the card
    label = gdev.card_label()
    print(label, flush=True)
    import jax
    try:
        devices = gdev.require_gpu()
    except gdev.NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    cache_dir = gdev.enable_compile_cache()
    print(f"jax.devices() = {devices}", flush=True)
    print(f"compilation cache: {cache_dir or 'off'}", flush=True)
    want = 4 if opts.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from gridpp_tpu import native
    native_ok = native.get_lib() is not None
    failures = []
    _report([("native engine loaded", {"ok": native_ok})], label, failures)

    meter = CompileMeter()
    t_start = time.perf_counter()
    if opts.four:
        phases = [("four cards", lambda: check_four(meter=meter))]
    else:
        state = {}

        def phase2():
            rows, state["resolve_s"] = check_pipeline(meter=meter)
            return rows

        phases = [
            ("phase 2: Pipeline 2000^2/10k", phase2),
            ("phase 3: ensembles 500^2 vs host",
             lambda: check_ensemble(meter=meter)),
            # max_points=8 once made XLA:GPU's compiler segfault on the
            # EnSI/utem update (ops/oi_ensi._mm)
            ("phase 3: ensembles 128^2, max_points=8, vs host",
             lambda: check_ensemble(n=128, n_obs=400, max_points=8,
                                    meter=meter)),
            ("phase 3: ensembles 2000^2 on the card",
             lambda: check_ensemble_full(meter=meter)),
            ("phase 4: device ops 2000^2",
             lambda: check_device_ops(meter=meter)),
            ("phase 4: XLA stencil times 2000^2",
             lambda: check_stencil_times(resolve_s=state.get("resolve_s"))),
            ("phase 5: public API", check_public_api),
        ]
    for title, fn in phases:
        print(f"== {title} (t={time.perf_counter() - t_start:.1f}s)",
              flush=True)
        try:
            rows = fn()
        except Exception:  # reported, and the run exits non-zero
            traceback.print_exc()
            rows = [(title, {"ok": False, "error": "exception (above)"})]
        _report(rows, label, failures)
    print(f"== done in {time.perf_counter() - t_start:.1f}s; "
          f"failures: {failures}", flush=True)
    if failures:
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
