"""Multi-host scaling harness for the north-star pipeline.

A CPU-only tool: it simulates an N-host job on one machine with N
processes, each pinned to the CPU backend (JAX_PLATFORMS=cpu) with one XLA
device and one physical core per "host", federated with jax.distributed
over localhost. It checks that the distributed neighbourhood+OI step
partitions cleanly (parity against the single-process result) and reports
the simulated strong-scaling efficiency, which says nothing about a GPU.
tests/test_distributed.py runs it.

    python tools/scaling_multihost.py [--hosts 2] [--n 512] [--obs 2000]
                                      [--out report.json]

Prints one JSON line (and writes it to --out when given).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def worker():
    """One simulated host: build global arrays, run the step, time it."""
    import time

    pid = int(os.environ["GRIDPP_PROCESS_ID"])
    nproc = int(os.environ["GRIDPP_NUM_PROCESSES"])
    n = int(os.environ["GRIDPP_SCALE_N"])
    n_obs = int(os.environ["GRIDPP_SCALE_OBS"])
    out_path = os.environ["GRIDPP_SCALE_OUT"]
    hg = os.environ.get("GRIDPP_SCALE_HOSTGRID", "")
    host_shape = tuple(int(v) for v in hg.split("x")) if hg else None

    # Pin this "host" to its own physical core so N simulated hosts do not
    # share compute (otherwise strong scaling is meaningless)
    ncpu = os.cpu_count() or 1
    os.sched_setaffinity(0, {pid % ncpu})

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from gridpp_tpu.parallel import distributed as dist

    if nproc > 1:
        dist.initialize()
    mesh = dist.global_mesh(host_shape=host_shape)

    import gridpp_tpu as gridpp
    from gridpp_tpu.api.oi import _origin, _resolved_fields

    rng = np.random.default_rng(0)
    lats, lons = np.meshgrid(np.linspace(55, 62, n),
                             np.linspace(5, 12, n), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    bpoints = grid.to_points()
    pts = gridpp.Points(rng.uniform(55, 62, n_obs),
                        rng.uniform(5, 12, n_obs),
                        np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    structure = gridpp.BarnesStructure(50000.0)
    pback = gridpp.nearest(grid, pts, background)
    pobs = (pback + rng.normal(0, 1, n_obs)).astype(np.float32)
    ratios = np.full(n_obs, 0.1, np.float32)

    origin = _origin(bpoints)
    p1 = _resolved_fields(bpoints, structure, origin)
    p1 = {k: np.asarray(v, np.float32).reshape(n, n) for k, v in p1.items()}
    opts_fields = _resolved_fields(pts.__class__(
        pts.lats, pts.lons, pts.elevs, pts.lafs), structure, origin)
    opts_fields = {k: np.asarray(v, np.float32)
                   for k, v in opts_fields.items()}

    # This host's contiguous block of the grid (y-split by default;
    # a 2-D host grid splits both axes, exercising corner halos and
    # both-axis host boundaries)
    py, px = mesh.devices.shape
    assert n % py == 0 and n % px == 0, "grid must divide the mesh"
    ly, lx = dist.local_block_slices((n, n), host_shape)

    g_bg = dist.global_field(background[ly, lx], mesh)
    g_p1 = {k: dist.global_field(v[ly, lx], mesh) for k, v in p1.items()}
    r_obsf = {k: dist.replicate(v, mesh) for k, v in opts_fields.items()}
    r_pobs = dist.replicate(pobs, mesh)
    r_pbg = dist.replicate(pback, mesh)
    r_rat = dist.replicate(ratios, mesh)

    step = dist.make_distributed_step(mesh, structure, halfwidth=7,
                                      statistic=int(gridpp.Mean),
                                      max_points=10,
                                      field_keys=tuple(p1.keys()))
    out = step(g_bg, g_p1, r_obsf, r_pobs, r_pbg, r_rat)
    jax.block_until_ready(out)  # compile + warm
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(g_bg, g_p1, r_obsf, r_pobs, r_pbg, r_rat)
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters

    result = dist.gather_to_host(out)
    if jax.process_index() == 0:
        import hashlib
        digest = hashlib.sha256(
            np.ascontiguousarray(result).tobytes()).hexdigest()
        with open(out_path, "w") as f:
            json.dump({"time_s": dt, "checksum": float(np.nansum(result)),
                       "digest": digest,
                       "shape": list(result.shape),
                       "n_devices": len(jax.devices()),
                       "n_hosts": jax.process_count()}, f)


def launch(hosts: int, n: int, n_obs: int, port: int, timeout: int = 600,
           host_grid: str = ""):
    """Spawn `hosts` worker processes; return process-0's result dict."""
    with tempfile.TemporaryDirectory() as td:
        out_path = os.path.join(td, "result.json")
        env_base = dict(os.environ)
        env_base.update({
            "GRIDPP_SCALE_N": str(n),
            "GRIDPP_SCALE_OBS": str(n_obs),
            "GRIDPP_SCALE_OUT": out_path,
            "GRIDPP_SCALE_HOSTGRID": host_grid,
            "GRIDPP_NUM_PROCESSES": str(hosts),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        })
        if hosts > 1:
            env_base["GRIDPP_COORDINATOR"] = f"localhost:{port}"
        procs = []
        for pid in range(hosts):
            env = dict(env_base)
            env["GRIDPP_PROCESS_ID"] = str(pid)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker"],
                env=env, cwd=ROOT))
        codes = [p.wait(timeout=timeout) for p in procs]
        if any(codes):
            raise RuntimeError(f"worker exit codes: {codes}")
        with open(out_path) as f:
            return json.load(f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--obs", type=int, default=2000)
    ap.add_argument("--port", type=int, default=52525)
    ap.add_argument("--host-grid", default="", dest="host_grid",
                    help="2-D host layout HYxHX (e.g. 2x2); default "
                         "splits only the y axis between hosts")
    ap.add_argument("--timeout", type=int, default=600,
                    help="per-launch worker wall-clock limit in seconds "
                         "(raise for north-star-scale grids)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    args = ap.parse_args()
    if args.worker:
        worker()
        return

    single = launch(1, args.n, args.obs, args.port, args.timeout)
    multi = launch(args.hosts, args.n, args.obs, args.port + 1,
                   args.timeout, args.host_grid)
    speedup = single["time_s"] / multi["time_s"]
    efficiency = speedup / args.hosts
    parity = abs(single["checksum"] - multi["checksum"]) <= \
        1e-5 * max(abs(single["checksum"]), 1.0)
    bit_parity = single.get("digest") == multi.get("digest")
    report = {
        "metric": "multihost_strong_scaling_efficiency",
        "grid": f"{args.n}x{args.n}",
        "obs": args.obs,
        "hosts": args.hosts,
        "host_grid": args.host_grid or f"{args.hosts}x1",
        "t_1host_s": round(single["time_s"], 4),
        f"t_{args.hosts}host_s": round(multi["time_s"], 4),
        "speedup": round(speedup, 3),
        "efficiency": round(efficiency, 3),
        "parity_ok": bool(parity),
        "bit_parity": bool(bit_parity),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
