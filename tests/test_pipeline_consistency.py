"""Pipeline serving paths vs the plain API on randomized networks.

Round-1 review: "no test pits the tiled OI path against the flat path on
randomized networks with missing obs". These tests randomize the obs
network, inject missing obs/background values, and require the tiled
general path, the flat (non-tiled) path, the static-ratio fast path and
the plain numpy API to agree.
"""
import numpy as np
import pytest

import gridpp_tpu as gridpp


def _problem(seed, n=40, n_obs=60, nan_obs=0.2):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, n),
                             np.linspace(5, 8, n), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    pts = gridpp.Points(rng.uniform(55, 58, n_obs),
                        rng.uniform(5, 8, n_obs),
                        np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    pback = gridpp.nearest(grid, pts, background)
    pobs = (pback + rng.normal(0, 2, n_obs)).astype(np.float32)
    pobs[rng.random(n_obs) < nan_obs] = np.nan
    ratios = np.full(n_obs, 0.2, np.float32)
    structure = gridpp.BarnesStructure(30000.0)
    return grid, pts, background, pback, pobs, ratios, structure


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiled_vs_flat_vs_plain(seed):
    """With the shortlist covering the whole network, both serving paths
    must reproduce the plain API bit-for-bit semantics; with a capped
    shortlist they must agree with each other and stay within the
    documented approximation of the plain result (missing obs can push
    true top-rho candidates past the shortlist cut)."""
    grid, pts, background, pback, pobs, ratios, structure = _problem(seed)
    max_points = 8
    n_obs = pts.size()

    plain = gridpp.optimal_interpolation(grid, background, pts, pobs,
                                         ratios, pback, structure,
                                         max_points)

    # full shortlist: exact
    tiled = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                            max_points=max_points, tiled=True,
                            candidates=n_obs)
    flat = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                           max_points=max_points, tiled=False,
                           candidates=n_obs)
    out_tiled = tiled(background, pobs, ratios)
    out_flat = flat(background, pobs, ratios)
    np.testing.assert_allclose(out_tiled, plain, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out_flat, plain, rtol=1e-4, atol=1e-3)

    # capped shortlist: tiled == flat, and close to plain
    tiled_c = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                              max_points=max_points, tiled=True,
                              candidates=2 * max_points)
    flat_c = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                             max_points=max_points, tiled=False,
                             candidates=2 * max_points)
    out_tc = tiled_c(background, pobs, ratios)
    out_fc = flat_c(background, pobs, ratios)
    np.testing.assert_allclose(out_tc, out_fc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_tc, plain, rtol=0.05, atol=0.5)


def test_fast_path_matches_general_when_all_valid():
    grid, pts, background, pback, pobs, ratios, structure = _problem(
        7, nan_obs=0.0)
    max_points = 8
    pipe = gridpp.Pipeline(grid, pts, structure, halfwidth=3,
                           statistic=gridpp.Mean, max_points=max_points,
                           tiled=True, ratios=ratios)
    import jax.numpy as jnp
    fast = np.asarray(pipe.run_device(jnp.asarray(background),
                                      jnp.asarray(pobs), path="fast",
                                      assume_valid=True))
    general = np.asarray(pipe.run_device(jnp.asarray(background),
                                         jnp.asarray(pobs), ratios,
                                         path="general"))
    np.testing.assert_allclose(fast, general, rtol=1e-4, atol=1e-3)


def test_missing_background_cells():
    grid, pts, background, pback, pobs, ratios, structure = _problem(11)
    background = background.copy()
    background[::5, ::7] = np.nan
    pback = gridpp.nearest(grid, pts, background)
    plain = gridpp.optimal_interpolation(grid, background, pts, pobs,
                                         ratios, pback, structure, 8)
    pipe = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                           max_points=8, tiled=True)
    out = pipe(background, pobs, ratios)
    # NaN background cells stay NaN in both
    assert np.isnan(out[::5, ::7]).all()
    np.testing.assert_allclose(out, plain, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dropout", [0.5, 0.7, 0.9])
@pytest.mark.parametrize("seed", [0, 1])
def test_shortlist_boundary_heavy_dropout(seed, dropout):
    """The documented approximation boundary (api/pipeline.py docstring):
    the serving path matches the plain API exactly whenever at least
    max_points shortlisted candidates carry valid obs. With a FULL
    shortlist (candidates = n_obs) that holds at any dropout level; with
    a capped shortlist heavy dropout may push true top-rho candidates
    past the cut, and the divergence must be graceful (finite, tiled ==
    flat, biased toward the background, never wild)."""
    grid, pts, background, pback, pobs, ratios, structure = _problem(
        seed, nan_obs=dropout)
    max_points = 8
    n_obs = pts.size()

    plain = gridpp.optimal_interpolation(grid, background, pts, pobs,
                                         ratios, pback, structure,
                                         max_points)

    # Full shortlist: exact at ANY dropout level.
    full = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                           max_points=max_points, tiled=True,
                           candidates=n_obs)
    np.testing.assert_allclose(full(background, pobs, ratios), plain,
                               rtol=1e-4, atol=1e-3)

    # Capped shortlist under heavy dropout: documented graceful
    # divergence. tiled and flat must still agree with each other.
    tiled_c = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                              max_points=max_points, tiled=True,
                              candidates=2 * max_points)
    flat_c = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                             max_points=max_points, tiled=False,
                             candidates=2 * max_points)
    out_tc = tiled_c(background, pobs, ratios)
    out_fc = flat_c(background, pobs, ratios)
    np.testing.assert_allclose(out_tc, out_fc, rtol=1e-5, atol=1e-5)
    assert np.isfinite(out_tc).all()
    # Graceful: where the shortlist loses candidates the increment can
    # only shrink toward the background, so the serving-path increment
    # magnitude is bounded by the plain increment envelope.
    inc_plain = np.abs(plain - background).max()
    inc_serve = np.abs(out_tc - background).max()
    assert inc_serve <= inc_plain * 1.5 + 1e-3


def test_shortlist_boundary_clustered_dropout():
    """Clustered dropout (a whole sub-region loses its obs): gridpoints
    near the dead cluster fall below max_points valid candidates; the
    result must stay finite and match plain where the network is
    intact."""
    seed = 5
    grid, pts, background, pback, pobs, ratios, structure = _problem(
        seed, nan_obs=0.0)
    max_points = 8
    pobs = pobs.copy()
    # kill every obs in the northern half
    dead = np.asarray(pts.lats) > 56.5
    pobs[dead] = np.nan
    assert dead.sum() > 10

    plain = gridpp.optimal_interpolation(grid, background, pts, pobs,
                                         ratios, pback, structure,
                                         max_points)
    pipe = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                           max_points=max_points, tiled=True,
                           candidates=2 * max_points)
    out = pipe(background, pobs, ratios)
    assert np.isfinite(out).all()
    # far southern rows see only live obs -> shortlist boundary not hit
    np.testing.assert_allclose(out[:8], plain[:8], rtol=1e-4, atol=1e-3)
    # northern rows (dead cluster) must return the background like plain
    np.testing.assert_allclose(out[-3:], plain[-3:], rtol=1e-4, atol=1e-3)


def test_shortlist_candidates_equals_max_points():
    """candidates == max_points edge: zero slack. With all obs valid the
    shortlist IS the top-k, so the result is exact; with dropout it
    degrades gracefully."""
    grid, pts, background, pback, pobs, ratios, structure = _problem(
        9, nan_obs=0.0)
    max_points = 8
    plain = gridpp.optimal_interpolation(grid, background, pts, pobs,
                                         ratios, pback, structure,
                                         max_points)
    pipe = gridpp.Pipeline(grid, pts, structure, halfwidth=0,
                           max_points=max_points, tiled=True,
                           candidates=max_points)
    out = pipe(background, pobs, ratios)
    np.testing.assert_allclose(out, plain, rtol=1e-4, atol=1e-3)

    pobs2 = pobs.copy()
    pobs2[::3] = np.nan
    out2 = pipe(background, pobs2, ratios)
    assert np.isfinite(out2).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_ensi_pipeline_vs_plain(seed):
    """EnsiPipeline (device serving path) vs optimal_interpolation_ensi
    on a randomized network with missing obs."""
    rng = np.random.default_rng(100 + seed)
    n, n_obs, e = 30, 50, 6
    lats, lons = np.meshgrid(np.linspace(55, 58, n),
                             np.linspace(5, 8, n), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    pts = gridpp.Points(rng.uniform(55, 58, n_obs),
                        rng.uniform(5, 8, n_obs),
                        np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n, e)).astype(np.float32)
    structure = gridpp.BarnesStructure(30000.0)
    # pbackground: nearest-gather per member, as the pipeline does
    idx = grid.nearest_map(pts.lats, pts.lons)
    pback = background.reshape(-1, e)[idx]
    pobs = (pback.mean(axis=1) + rng.normal(0, 2, n_obs)).astype(
        np.float32)
    pobs[rng.random(n_obs) < 0.2] = np.nan
    psig = np.full(n_obs, 1.5, np.float32)

    want = gridpp.optimal_interpolation_ensi(
        grid, background, pts, pobs, psig, pback, structure, 5)
    pipe = gridpp.EnsiPipeline(grid, pts, structure, max_points=5,
                               candidates=n_obs)
    got = pipe(background, pobs, psig)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_ensi_pipeline_assume_valid_matches_general():
    """The static-prefix fast path (assume_valid=True) must match the
    general per-cycle top-k path exactly when every value is finite."""
    import jax.numpy as jnp
    rng = np.random.default_rng(42)
    n, n_obs, e = 30, 80, 6
    lats, lons = np.meshgrid(np.linspace(55, 58, n),
                             np.linspace(5, 8, n), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    pts = gridpp.Points(rng.uniform(55, 58, n_obs),
                        rng.uniform(5, 8, n_obs),
                        np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n, e)).astype(np.float32)
    pobs = rng.normal(280, 5, n_obs).astype(np.float32)
    psig = np.full(n_obs, 1.5, np.float32)
    structure = gridpp.BarnesStructure(30000.0)
    pipe = gridpp.EnsiPipeline(grid, pts, structure, halfwidth=2,
                               statistic=gridpp.Mean, max_points=5)
    gen, _ = pipe.run_device(jnp.asarray(background), jnp.asarray(pobs),
                             jnp.asarray(psig))
    fast, _ = pipe.run_device(jnp.asarray(background), jnp.asarray(pobs),
                              jnp.asarray(psig), assume_valid=True)
    np.testing.assert_array_equal(np.asarray(gen), np.asarray(fast))


def test_ensi_pipeline_smoothing():
    """halfwidth > 0 smooths each member before the ensemble update."""
    rng = np.random.default_rng(3)
    n, n_obs, e = 24, 20, 4
    lats, lons = np.meshgrid(np.linspace(55, 57, n),
                             np.linspace(5, 7, n), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    pts = gridpp.Points(rng.uniform(55, 57, n_obs),
                        rng.uniform(5, 7, n_obs),
                        np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n, e)).astype(np.float32)
    structure = gridpp.BarnesStructure(30000.0)
    sm = np.stack([gridpp.neighbourhood(background[:, :, k], 2,
                                        gridpp.Mean)
                   for k in range(e)], axis=-1).astype(np.float32)
    idx = grid.nearest_map(pts.lats, pts.lons)
    pback = sm.reshape(-1, e)[idx]
    pobs = (pback.mean(axis=1) + rng.normal(0, 2, n_obs)).astype(
        np.float32)
    psig = np.full(n_obs, 1.5, np.float32)

    want = gridpp.optimal_interpolation_ensi(
        grid, sm, pts, pobs, psig, pback, structure, 5)
    pipe = gridpp.EnsiPipeline(grid, pts, structure, halfwidth=2,
                               statistic=gridpp.Mean, max_points=5,
                               candidates=n_obs)
    got = pipe(background, pobs, psig)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_guarded_general_cache_invalidation():
    """The guarded general path caches solved weights device-side and
    refreshes them only when a device guard sees the obs validity or
    ratios change. Every cycle kind must equal the full re-solve
    (path="resolve") bit for bit: first cycle (cold cache), same
    validity + new obs values (cache hit: cached weights, new
    innovations), obs knocked out mid-stream (validity change ->
    rebuild), obs restored + new ratios (ratio change -> rebuild)."""
    import jax.numpy as jnp
    grid, pts, background, pback, pobs, ratios, structure = _problem(
        7, nan_obs=0.0)
    pipe = gridpp.Pipeline(grid, pts, structure, halfwidth=3,
                           statistic=gridpp.Mean, max_points=8,
                           tiled=True)
    bg = jnp.asarray(background)

    def check(pobs_c, ratios_c):
        got = np.asarray(pipe.run_device(bg, jnp.asarray(pobs_c),
                                         ratios_c, path="general"))
        want = np.asarray(pipe.run_device(bg, jnp.asarray(pobs_c),
                                          ratios_c, path="resolve"))
        np.testing.assert_array_equal(got, want)

    check(pobs, ratios)                      # cold cache
    check(pobs + 1.0, ratios)                # cache hit, new innovations
    pobs_gap = pobs.copy()
    pobs_gap[::3] = np.nan                   # validity change -> rebuild
    check(pobs_gap, ratios)
    check(pobs_gap - 0.5, ratios)            # cache hit on gapped network
    check(pobs, np.full_like(ratios, 0.05))  # ratios change -> rebuild
    check(pobs, ratios)                      # back to original ratios


def test_serve_stream_matches_per_cycle_calls():
    """serve_stream yields one analysis per cycle, in order, equal to
    the per-cycle __call__ results — for Pipeline, EnsiPipeline and
    MultiEnsiPipeline (the overlap must never reorder or cross-wire
    cycles)."""
    rng = np.random.default_rng(3)
    grid, pts, background, pback, pobs, ratios, structure = _problem(
        3, nan_obs=0.0)
    n_obs = pts.size()
    n_cyc, e = 4, 3

    pipe = gridpp.Pipeline(grid, pts, structure, halfwidth=2,
                           max_points=6, ratios=ratios)
    cycles = [(background + np.float32(i), pobs + np.float32(i))
              for i in range(n_cyc)]
    streamed = list(pipe.serve_stream(cycles))
    assert len(streamed) == n_cyc
    for got, args in zip(streamed, cycles):
        np.testing.assert_array_equal(got, pipe(*args))

    epipe = gridpp.EnsiPipeline(grid, pts, structure, max_points=6)
    bg3 = (np.repeat(background[:, :, None], e, axis=2)
           + rng.normal(0, 1, background.shape + (e,))).astype(np.float32)
    psig = np.full(n_obs, 1.5, np.float32)
    ecycles = [(bg3 + np.float32(i), pobs, psig) for i in range(n_cyc)]
    streamed = list(epipe.serve_stream(ecycles))
    assert len(streamed) == n_cyc
    for got, args in zip(streamed, ecycles):
        np.testing.assert_array_equal(got, epipe(*args))

    mpipe = gridpp.MultiEnsiPipeline(grid, pts, structure,
                                     variant="ebesc", max_points=6)
    pobs_e = (np.asarray(pback)[:, None]
              + rng.normal(0, 1, (n_obs, e))).astype(np.float32)
    mcycles = [(bg3 + np.float32(i), pobs_e, ratios)
               for i in range(n_cyc)]
    streamed = list(mpipe.serve_stream(mcycles))
    assert len(streamed) == n_cyc
    for got, args in zip(streamed, mcycles):
        np.testing.assert_array_equal(got, mpipe(*args))


def test_flat_pipeline_ratios_default_cycle():
    """A flat-path (small-grid) Pipeline built with ratios= must serve
    run_device cycles without re-passing pratios (regression: the
    general fallback to the construction ratios was dropped twice in
    round 4; the chip smoke gate caught it both times)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    ny, nx, p = 16, 20, 12
    lats, lons = np.meshgrid(np.linspace(55, 56, ny),
                             np.linspace(5, 6, nx), indexing="ij")
    grid = gridpp.Grid(lats, lons)
    points = gridpp.Points(rng.uniform(55.05, 55.95, p),
                           rng.uniform(5.05, 5.95, p))
    structure = gridpp.BarnesStructure(30000.0)
    ratios = np.full(p, 0.1, np.float32)
    pipe = gridpp.Pipeline(grid, points, structure, halfwidth=3,
                           statistic=gridpp.Mean, max_points=5,
                           ratios=ratios)
    assert pipe._static_w is None  # flat path (no static weights)
    bg = jnp.asarray(rng.normal(280, 5, (ny, nx)).astype(np.float32))
    pobs = jnp.asarray(rng.normal(280, 5, p).astype(np.float32))
    out = pipe.run_device(bg, pobs)  # no pratios passed
    assert np.isfinite(np.asarray(out)).all()
    outg = pipe.run_device(bg, pobs, path="general")
    np.testing.assert_allclose(np.asarray(out), np.asarray(outg))
