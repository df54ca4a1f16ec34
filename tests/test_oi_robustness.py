"""OI robustness: EnSI conditioning guard and exact large-grid candidate
selection (reference oi_ensi.cpp:386-418,557-566 and oi.cpp:233-281)."""
import numpy as np
import pytest

import gridpp_tpu as gridpp
from gridpp_tpu.api import oi as oi_api


def _grid(n, lat0=55.0, lon0=5.0, dlat=5.0):
    lats, lons = np.meshgrid(np.linspace(lat0, lat0 + dlat, n),
                             np.linspace(lon0, lon0 + dlat, n),
                             indexing="ij")
    elevs = ((np.arange(n)[:, None] * 13 + np.arange(n)[None, :] * 7)
             % 500).astype(float)
    return gridpp.Grid(lats, lons, elevs, np.zeros((n, n)))


class TestEnsiConditioning:
    def test_zero_sigma_falls_back_to_background(self, capsys):
        """Zero obs sigma makes Rinv infinite -> Pinv unusable; the
        reference keeps the raw ensemble there and warns."""
        n, e, p = 6, 4, 3
        grid = _grid(n)
        rng = np.random.default_rng(0)
        bg = rng.normal(280, 2, (n, n, e)).astype(np.float32)
        pts = gridpp.Points(np.full(p, 57.0), np.linspace(6, 8, p),
                            np.zeros(p), np.zeros(p))
        pobs = np.full(p, 283.0, np.float32)
        psigmas = np.zeros(p, np.float32)  # degenerate
        pbg = rng.normal(280, 2, (p, e)).astype(np.float32)
        structure = gridpp.BarnesStructure(200000.0)
        out = gridpp.optimal_interpolation_ensi(grid, bg, pts, pobs,
                                                psigmas, pbg, structure, 10)
        np.testing.assert_array_equal(out, bg)
        assert "Condition number error" in capsys.readouterr().out

    def test_healthy_case_still_updates(self):
        n, e, p = 6, 4, 3
        grid = _grid(n)
        rng = np.random.default_rng(1)
        bg = rng.normal(280, 2, (n, n, e)).astype(np.float32)
        pts = gridpp.Points(np.full(p, 57.0), np.linspace(6, 8, p),
                            np.zeros(p), np.zeros(p))
        pobs = np.full(p, 290.0, np.float32)
        psigmas = np.ones(p, np.float32)
        # the ensemble AT the obs points (correlated with the grid
        # ensemble, as in real usage) so the mean update has a direction
        pbg = np.stack([gridpp.nearest(grid, pts, bg[:, :, k])
                        for k in range(e)], axis=1).astype(np.float32)
        structure = gridpp.BarnesStructure(200000.0)
        out = gridpp.optimal_interpolation_ensi(grid, bg, pts, pobs,
                                                psigmas, pbg, structure, 10)
        assert np.isfinite(out).all()
        assert not np.array_equal(out, bg)
        assert np.nanmean(out) > np.nanmean(bg)  # pulled toward obs


class TestChunkedEnsiParity:
    def test_chunked_blocks_match_global_query(self, monkeypatch):
        """EnSI's large-grid per-block ball queries must reproduce the
        global-candidate path (mirrors the deterministic OI test)."""
        rng = np.random.default_rng(0)
        n, e, p = 48, 4, 100
        lats, lons = np.meshgrid(np.linspace(55, 60, n),
                                 np.linspace(5, 10, n), indexing="ij")
        grid = gridpp.Grid(lats, lons)
        bg = rng.normal(280, 2, (n, n, e)).astype(np.float32)
        pts = gridpp.Points(rng.uniform(55, 60, p), rng.uniform(5, 10, p),
                            np.zeros(p), np.zeros(p))
        pbg = np.stack([gridpp.nearest(grid, pts, bg[:, :, k])
                        for k in range(e)], axis=1).astype(np.float32)
        pobs = (pbg.mean(1) + rng.normal(0, 1, p)).astype(np.float32)
        sig = np.ones(p, np.float32)
        st = gridpp.BarnesStructure(50000.0)
        ref = gridpp.optimal_interpolation_ensi(grid, bg, pts, pobs, sig,
                                                pbg, st, 8)
        monkeypatch.setattr(oi_api, "_BALL_QUERY_MAX", 16)
        grid2 = gridpp.Grid(lats.copy(), lons)
        out = gridpp.optimal_interpolation_ensi(grid2, bg, pts, pobs, sig,
                                                pbg, st, 8)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


class TestLargeGridExactSelection:
    def test_knn_growth_matches_ball_query_with_elev_kernel(self,
                                                            monkeypatch):
        """>_BALL_QUERY_MAX gridpoints with an active elevation kernel:
        rho is NOT monotone in distance, so only a complete in-radius
        shortlist selects the same top-rho set as the exact ball query
        (reference semantics oi.cpp:250-281)."""
        n = 64  # will be forced through the "large" path via monkeypatch
        grid = _grid(n)
        rng = np.random.default_rng(2)
        p = 400
        pts = gridpp.Points(rng.uniform(55, 60, p), rng.uniform(5, 10, p),
                            rng.uniform(0, 500, p), np.zeros(p))
        bg = rng.normal(280, 2, (n, n)).astype(np.float32)
        pback = gridpp.nearest(grid, pts, bg)
        pobs = pback + rng.normal(0, 1, p).astype(np.float32)
        ratios = np.full(p, 0.2, np.float32)
        # elev kernel v=100 m makes nearby-but-wrong-elevation obs lose to
        # farther same-elevation obs
        structure = gridpp.BarnesStructure(50000.0, 100.0)

        exact = gridpp.optimal_interpolation(grid, bg, pts, pobs, ratios,
                                             pback, structure, 5)
        # force the capped-kNN + growth path
        monkeypatch.setattr(oi_api, "_BALL_QUERY_MAX", 16)
        grid2 = _grid(n)  # fresh caches
        approx = gridpp.optimal_interpolation(grid2, bg, pts, pobs, ratios,
                                              pback, structure, 5)
        np.testing.assert_allclose(approx, exact, rtol=1e-6, atol=1e-6)
