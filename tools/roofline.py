"""Roofline characterization of the device-side hot kernels.

For each production kernel, FLOPs (XLA cost analysis) and minimum io
bytes are combined with on-device wall time (ITERS chained pipelined
dispatches amortize per-dispatch latency; see `characterize` for why a
fori_loop harness is wrong) to derive achieved GFLOP/s, effective io
GB/s, and % of the card's published roofline (_CHIP_PEAKS). SURVEY.md
section 5 asks for exactly this: per-kernel roofline notes guiding perf
work.

    python tools/roofline.py              # the GPU
    python tools/roofline.py --trace DIR  # also write a jax.profiler
                                          # trace (open with xprof /
                                          # tensorboard-plugin-profile)

Prints a markdown table and one JSON line of the rows. A device_kind
missing from _CHIP_PEAKS is an error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


ITERS = 300

# Published peaks for the %-of-roofline columns, keyed by
# jax.Device.device_kind. Source: NVIDIA H100 Tensor Core GPU data sheet,
# SXM part, dense rates at the full 700 W power limit: HBM3 at 3.35 TB/s,
# 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32. A card
# set below 700 W (nvidia-smi power.limit) cannot hold these rates.
_CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"gbytes_s": 3_350.0, "gflops": 67_000.0,
                              "tf32_gflops": 495_000.0},
}


def chip_peaks(kind=None):
    """Peaks of `kind` (default: the first JAX device's device_kind).
    Raises ValueError for a device with no published peaks here."""
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    try:
        return _CHIP_PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device_kind {kind!r}; "
                         "add its data-sheet row to _CHIP_PEAKS") from None


_MEASURED_BW = None


def measured_peak_bw():
    """The device's achievable memory bandwidth (GB/s), measured.

    Times XLA's own fused elementwise add (read + write, the same
    traffic shape as the stencil kernels) on a large array. A kernel's
    share of this says more about the kernel than its share of the
    published peak, which no program reaches.
    """
    global _MEASURED_BW
    if _MEASURED_BW is not None:
        return _MEASURED_BW
    import jax
    import jax.numpy as jnp

    x = jax.block_until_ready(jnp.ones((8192, 8192), jnp.float32))
    f = jax.jit(lambda a: a + 1.0)
    jax.block_until_ready(f(x))
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [f(x) for _ in range(8)]
        jax.block_until_ready(outs)
        dt = (time.perf_counter() - t0) / 8
        best = max(best, 2 * x.nbytes / dt / 1e9)
    _MEASURED_BW = best
    return best


def characterize(name, make_fn, *args, analytic_flops=None):
    """Time a kernel and derive achieved GFLOP/s / io GB/s.

    Timing: ITERS jitted dispatches, chained (output fed back as arg0
    when shape-compatible, so no iteration is dead code) and pipelined
    (async dispatch); per-dispatch latency amortizes at this depth. A
    lax.fori_loop harness is NOT used: the loop carry forces a
    per-iteration buffer copy that inflates sub-ms kernels.

    FLOPs come from XLA's cost analysis unless analytic_flops overrides
    it. Bytes are the MINIMUM io traffic (sum of input + output array
    sizes): "GB/s (io)" is the effective bandwidth a user-visible call
    achieves, a lower bound on
    actual HBM traffic (fused intermediates excluded by design; XLA's
    "bytes accessed" overcounts on-chip temporaries by orders of
    magnitude on fused programs).
    """
    import jax

    fn = make_fn()
    jfn = jax.jit(fn)
    lowered = jfn.lower(*args)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0)) if analytic_flops is None \
        else float(analytic_flops)

    largs = tuple(jax.device_put(a) for a in args)
    out = jfn(*largs)
    jax.block_until_ready(out)  # compile + warm

    def nbytes(t):
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(t))

    bytes_acc = nbytes(largs) + nbytes(out)
    first = jax.tree.leaves(out)[0]
    chain = hasattr(first, "shape") and getattr(largs[0], "shape", None) \
        == first.shape and largs[0].dtype == first.dtype
    t0 = time.perf_counter()
    cur = largs[0]
    for _ in range(ITERS):
        out = jfn(cur, *largs[1:])
        if chain:
            cur = jax.tree.leaves(out)[0]
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / ITERS
    row = {
        "kernel": name,
        "time_ms": dt * 1e3,
        "gflops": flops / dt / 1e9 if flops else 0.0,
        "gbytes_s": bytes_acc / dt / 1e9 if bytes_acc else 0.0,
        "flops_per_byte": flops / bytes_acc if bytes_acc else 0.0,
    }
    peaks = chip_peaks()
    # % of the roofline bound: a kernel is at its roofline when it
    # saturates whichever resource (HBM io BW or FLOPs) binds it
    frac_bw = row["gbytes_s"] / peaks["gbytes_s"]
    frac_fl = row["gflops"] / peaks["gflops"]
    row["pct_hbm_peak"] = 100.0 * frac_bw
    row["pct_flop_peak"] = 100.0 * frac_fl
    row["pct_roofline"] = 100.0 * max(frac_bw, frac_fl)
    # % of what this card sustains (see measured_peak_bw)
    row["pct_measured_bw"] = 100.0 * row["gbytes_s"] / measured_peak_bw()
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a jax.profiler trace of the benchmark "
                         "loops to DIR")
    opts = ap.parse_args()

    import contextlib
    import jax
    import jax.numpy as jnp

    import gridpp_tpu as gridpp
    from gridpp_tpu.constants import Statistic
    from gridpp_tpu.ops import neighbourhood as nops
    from gridpp_tpu.ops.oi import oi_block_dense

    from gridpp_tpu.device import card_label, require_gpu
    print(card_label(), flush=True)
    dev = require_gpu()[0]
    peaks = chip_peaks(dev.device_kind)
    print(f"device: {dev.platform} ({dev.device_kind})", flush=True)

    rng = np.random.default_rng(0)
    rows = []

    trace_ctx = (jax.profiler.trace(opts.trace) if opts.trace
                 else contextlib.nullcontext())
    _trace = contextlib.ExitStack()
    _trace.enter_context(trace_ctx)

    x2k = rng.random((2048, 2048)).astype(np.float32)
    rows.append(characterize(
        "neighbourhood mean 2048^2 h=7",
        lambda: (lambda a: nops.neighbourhood(a, 7, int(Statistic.Mean))),
        x2k))
    rows.append(characterize(
        "neighbourhood max 2048^2 h=7",
        lambda: (lambda a: nops.neighbourhood(a, 7, int(Statistic.Max))),
        x2k))
    thr = np.linspace(0, 1, 11).astype(np.float32)
    rows.append(characterize(
        "quantile_fast 2048^2 T=11",
        lambda: (lambda a, t: nops.neighbourhood_quantile_fast(
            a, 0.5, 7, t)), x2k, thr))

    # EnSI local ensemble transform update (the 2000^2 ensemble OI hot
    # block): gathered panels -> Pinv -> Newton-Schulz inverse sqrt ->
    # member increments. Pure XLA (cost analysis applies).
    from gridpp_tpu.ops.oi_ensi import _ensi_update
    be, ee, se = 16384, 10, 10
    y_pan = rng.normal(0, 5, (be, se, ee)).astype(np.float32)
    obs_pan = rng.normal(280, 5, (be, se)).astype(np.float32)
    sig_pan = np.full((be, se), 1.5, np.float32)
    rho_pan = rng.uniform(0.1, 1, (be, se)).astype(np.float32)
    yhat_pan = rng.normal(280, 5, (be, se)).astype(np.float32)
    bg_pan = rng.normal(280, 5, (be, ee)).astype(np.float32)

    def make_ensi_row():
        sel_valid = jnp.ones((be, se), bool)

        def fn(bgc, l_rho, l_obs, l_sig, l_y, l_yhat):
            out, _ = _ensi_update(None, sel_valid, l_rho, l_obs, l_sig,
                                  l_y, l_yhat, bgc, True)
            return out
        return fn

    rows.append(characterize(
        f"EnSI update B={be} E={ee} S={se}", make_ensi_row, bg_pan,
        rho_pan, obs_pan, sig_pan, y_pan, yhat_pan))

    # dense OI block: B gridpoints x P obs rho sweep + top-k + solve
    b, p, s = 16384, 4096, 10
    structure = gridpp.BarnesStructure(10000.0)
    from gridpp_tpu.api.oi import _origin, _resolved_fields
    pts = gridpp.Points(rng.uniform(55, 62, p), rng.uniform(5, 12, p),
                        np.zeros(p), np.zeros(p))
    gpts = gridpp.Points(rng.uniform(55, 62, b), rng.uniform(5, 12, b),
                         np.zeros(b), np.zeros(b))
    origin = _origin(gpts)
    p1 = {k: np.asarray(v, np.float32).reshape(b, 1)
          for k, v in _resolved_fields(gpts, structure, origin).items()}
    of = {k: np.asarray(v, np.float32)
          for k, v in _resolved_fields(pts, structure, origin).items()}
    bg = rng.normal(280, 5, b).astype(np.float32)
    pobs = rng.normal(280, 5, p).astype(np.float32)

    def make_oi():
        def fn(bg, p1x, p1y, p1z, p1e, p1l):
            p1d = {"x": p1x, "y": p1y, "z": p1z, "elev": p1e, "laf": p1l}
            out, _ = oi_block_dense(
                structure, p1d, {k: jnp.asarray(v) for k, v in of.items()},
                bg, jnp.ones_like(bg), jnp.asarray(pobs),
                jnp.asarray(pobs), jnp.full((p,), 0.1, jnp.float32), s,
                True)
            return out
        return fn

    rows.append(characterize(
        f"OI dense block B={b} P={p} S={s}", make_oi, bg,
        p1["x"], p1["y"], p1["z"], p1["elev"], p1["laf"]))

    # tiled-OI general serving sweep (the Pipeline per-cycle re-solve):
    # tile-union obs paging + batched solves, 512^2 grid, 4k obs
    from gridpp_tpu.ops import oi_tiled as tiled_ops
    n_t, p_t = 512, 4096
    lats, lons = np.meshgrid(np.linspace(55, 60, n_t),
                             np.linspace(5, 10, n_t), indexing="ij")
    tgrid = gridpp.Grid(lats, lons)
    tpts = gridpp.Points(rng.uniform(55, 60, p_t),
                         rng.uniform(5, 10, p_t),
                         np.zeros(p_t), np.zeros(p_t))
    tpipe = gridpp.Pipeline(tgrid, tpts, gridpp.BarnesStructure(20000.0),
                            halfwidth=0, max_points=10, tiled=True)
    geom = tpipe._geom
    gdev = tpipe._geom_dev
    static_keys = tuple(geom.static_keys)
    tobs_nn = tpipe._obs_nn
    tstruct = tpipe.structure
    tbg = rng.normal(280, 5, (n_t, n_t)).astype(np.float32)
    tpobs = rng.normal(280, 5, p_t).astype(np.float32)
    trat = np.full(p_t, 0.1, np.float32)

    def make_tiled():
        def fn(background, pobs, pratios, gd, obs_nn):
            flat = background.reshape(-1)
            pback = jnp.take(flat, obs_nn)
            valid01 = (jnp.isfinite(pobs)
                       & jnp.isfinite(pback)).astype(jnp.float32)
            packed = jnp.stack(
                [jnp.where(valid01 > 0, pobs, 0.0),
                 jnp.where(valid01 > 0, pback, 0.0),
                 pratios, valid01], axis=1)
            bg_t = tiled_ops.tile_fields(background, geom)
            out_t, _ = tiled_ops.oi_tiled_sweep(
                tstruct, gd, static_keys, bg_t, jnp.ones_like(bg_t),
                packed, 10, True)
            return tiled_ops.untile_fields(out_t, geom).reshape(
                background.shape)
        return fn

    rows.append(characterize(
        f"OI tiled general sweep {n_t}^2 {p_t} obs S=10", make_tiled,
        tbg, tpobs, trat, dict(gdev), np.asarray(tobs_nn)))

    _trace.close()
    if opts.trace:
        print(f"profiler trace written to {opts.trace}")

    print(f"published peaks used: {peaks['gbytes_s']:.0f} GB/s HBM, "
          f"{peaks['gflops'] / 1e3:.1f} TFLOP/s f32; measured copy "
          f"bandwidth {measured_peak_bw():.0f} GB/s")
    print("| kernel | time (ms) | GFLOP/s | GB/s (io) | FLOPs/byte "
          "| %HBM spec (io) | %measured BW | %roofline |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['kernel']} | {r['time_ms']:.2f} "
              f"| {r['gflops']:.1f} | {r['gbytes_s']:.1f} "
              f"| {r['flops_per_byte']:.2f} "
              f"| {r['pct_hbm_peak']:.0f}% | {r['pct_measured_bw']:.0f}% "
              f"| {r['pct_roofline']:.0f}% |")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
