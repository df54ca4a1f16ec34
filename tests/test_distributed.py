"""Multi-host distributed layer tests.

Parity of the distributed north-star step on the in-process 8-device CPU
mesh, plus a real 2-process (2 simulated hosts) federation via the
scaling harness (subprocess, jax.distributed over localhost).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gridpp_tpu as gridpp
from gridpp_tpu.api.oi import _origin, _resolved_fields
from gridpp_tpu.constants import Statistic
from gridpp_tpu.ops import neighbourhood as nops
from gridpp_tpu.ops.oi import oi_block_dense
from gridpp_tpu.parallel import distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(n=64, n_obs=200, seed=0):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 62, n),
                             np.linspace(5, 12, n), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    pts = gridpp.Points(rng.uniform(55, 62, n_obs),
                        rng.uniform(5, 12, n_obs),
                        np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    structure = gridpp.BarnesStructure(100000.0)
    pback = gridpp.nearest(grid, pts, background)
    pobs = (pback + rng.normal(0, 1, n_obs)).astype(np.float32)
    ratios = np.full(n_obs, 0.1, np.float32)
    return grid, pts, background, structure, pback, pobs, ratios


class TestDistributedStepParity:
    def test_matches_single_device(self):
        grid, pts, background, structure, pback, pobs, ratios = _problem()
        n = background.shape[0]
        bpoints = grid.to_points()
        origin = _origin(bpoints)
        p1 = {k: np.asarray(v, np.float32).reshape(n, n)
              for k, v in _resolved_fields(bpoints, structure,
                                           origin).items()}
        obs_f = {k: np.asarray(v, np.float32)
                 for k, v in _resolved_fields(pts, structure,
                                              origin).items()}

        mesh = dist.global_mesh()
        step = dist.make_distributed_step(mesh, structure, halfwidth=3,
                                          statistic=int(Statistic.Mean),
                                          max_points=8,
                                          field_keys=tuple(p1.keys()))
        g_bg = dist.global_field(background, mesh)
        g_p1 = {k: dist.global_field(v, mesh) for k, v in p1.items()}
        r_obs = {k: dist.replicate(v, mesh) for k, v in obs_f.items()}
        out = np.asarray(step(g_bg, g_p1, r_obs,
                              dist.replicate(pobs, mesh),
                              dist.replicate(pback, mesh),
                              dist.replicate(ratios, mesh)))

        # single-device reference: same kernels, no sharding
        sm = np.asarray(nops.neighbourhood(jnp.asarray(background), 3,
                                           int(Statistic.Mean)))
        flat = jnp.asarray(sm.reshape(-1))
        ref, _ = oi_block_dense(
            structure, {k: jnp.asarray(v.reshape(-1, 1))
                        for k, v in p1.items()},
            {k: jnp.asarray(v) for k, v in obs_f.items()},
            flat, jnp.ones_like(flat), jnp.asarray(pobs),
            jnp.asarray(pback), jnp.asarray(ratios), 8, True)
        np.testing.assert_allclose(out, np.asarray(ref).reshape(n, n),
                                   rtol=2e-5, atol=2e-4)


@pytest.mark.skipif(os.environ.get("GRIDPP_SKIP_SUBPROCESS") == "1",
                    reason="subprocess tests disabled")
class TestTwoHostFederation:
    def test_scaling_harness_two_hosts(self, tmp_path):
        """Full 2-process jax.distributed run (small problem): parity of
        the sharded result across simulated hosts."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_", "GRIDPP_"))}
        env["PATH"] = os.environ.get("PATH", "")
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "scaling_multihost.py"),
             "--hosts", "2", "--n", "128", "--obs", "400",
             "--port", "53141", "--out", str(tmp_path / "scaling.json")],
            capture_output=True, text=True, timeout=420, cwd=ROOT,
            env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        assert report["parity_ok"]
        assert report["bit_parity"]
        assert report["hosts"] == 2

    def test_scaling_harness_2x2_host_grid(self, tmp_path):
        """4 processes on a 2x2 host grid: both-axis host boundaries and
        corner halo exchange between simulated hosts, with parity against
        the single-process result."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_", "GRIDPP_"))}
        env["PATH"] = os.environ.get("PATH", "")
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "scaling_multihost.py"),
             "--hosts", "4", "--host-grid", "2x2", "--n", "128",
             "--obs", "400", "--port", "53161",
             "--out", str(tmp_path / "scaling.json")],
            capture_output=True, text=True, timeout=420, cwd=ROOT,
            env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        assert report["parity_ok"]
        assert report["bit_parity"]
        assert report["hosts"] == 4
        assert report["host_grid"] == "2x2"
