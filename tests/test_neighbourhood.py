"""Neighbourhood statistics tests.

The 5x5 grid with NaNs and the expectations are the behavioural spec from
reference tests/test_neighbourhood.py (hand-computed values).
"""
import numpy as np
import pytest

import gridpp_tpu as gridpp

"""
20 21 22 23 24
15 16 17 18 19
10 11 12 13 nan
5  6  7  nan  9
0  1  2  3  4
"""
values = np.reshape(range(25), [5, 5]).astype(float)
values[1, 3] = np.nan
values[2, 4] = np.nan

BOTH = [gridpp.neighbourhood, gridpp.neighbourhood_brute_force]


class TestInvalidArguments:
    def test_negative_halfwidth(self):
        for func in BOTH:
            with pytest.raises(ValueError):
                func(np.ones([5, 5]), -1, gridpp.Mean)

    def test_quantile_statistic(self):
        with pytest.raises(Exception):
            gridpp.neighbourhood(np.ones([5, 5]), 1, gridpp.Quantile)


class TestEmpty:
    def test_empty(self):
        for statistic in [gridpp.Mean, gridpp.Min, gridpp.Max, gridpp.Median,
                          gridpp.Std, gridpp.Variance]:
            for func in BOTH:
                output = func([[]], 1, statistic)
                assert output.ndim == 2 and output.size == 0


class TestMissing:
    def test_missing(self):
        empty = np.zeros([5, 5])
        empty[0:3, 0:3] = np.nan
        for func in BOTH:
            for statistic in [gridpp.Mean, gridpp.Min, gridpp.Max,
                              gridpp.Median, gridpp.Std, gridpp.Variance,
                              gridpp.RandomChoice]:
                output = func(empty, 1, statistic)
                assert np.isnan(np.array(output)[0:2, 0:2]).all()
            output = func(empty, 1, gridpp.Count)
            np.testing.assert_array_almost_equal(
                output, [[0, 0, 2, 4, 4], [0, 0, 3, 6, 6], [2, 3, 5, 7, 6],
                         [4, 6, 7, 8, 6], [4, 6, 6, 6, 4]])


class TestStatistics:
    def test_mean(self):
        for func in BOTH:
            output = func(values, 1, gridpp.Mean)
            assert output[2][2] == 12.5
            assert output[0][4] == pytest.approx(5.3333, abs=1e-4)
            output = func(values, 100, gridpp.Mean)
            assert (np.abs(np.array(output) - 12.086956) < 0.0001).all()
            output = np.array(func(values, 0, gridpp.Mean)).flatten()
            idx = np.where(np.isnan(output) == 0)[0]
            assert (np.isnan(output) == np.isnan(values.flatten())).all()
            assert (output[idx] == values.flatten()[idx]).all()

    def test_count(self):
        for func in BOTH:
            output = func(values, 1, gridpp.Count)
            assert output[2][2] == 8
            assert output[0][4] == 3
            output = func(values, 100, gridpp.Count)
            assert (np.abs(np.array(output) - 23) < 0.0001).all()
            output = np.array(func(values, 0, gridpp.Count))
            np.testing.assert_array_almost_equal(
                output, [[1, 1, 1, 1, 1], [1, 1, 1, 0, 1], [1, 1, 1, 1, 0],
                         [1, 1, 1, 1, 1], [1, 1, 1, 1, 1]])

    def test_min(self):
        for func in BOTH:
            output = func(values, 1, gridpp.Min)
            assert output[2][2] == 6
            assert output[0][4] == 3
            output = func(values, 100, gridpp.Min)
            assert (np.array(output) == 0).all()

    def test_max(self):
        for func in BOTH:
            output = func(values, 1, gridpp.Max)
            assert output[2][2] == 18
            assert output[0][4] == 9
            output = func(values, 100, gridpp.Max)
            assert (np.array(output) == 24).all()

    def test_std_variance(self):
        x = np.random.default_rng(7).random((20, 20)).astype(np.float32)
        fast_var = gridpp.neighbourhood(x, 2, gridpp.Variance)
        fast_std = gridpp.neighbourhood(x, 2, gridpp.Std)
        np.testing.assert_allclose(fast_std, np.sqrt(fast_var), atol=1e-5)

    def test_median(self):
        out = gridpp.neighbourhood(values, 1, gridpp.Median)
        assert out[2][2] == 12.5


class TestRandomChoice:
    def test_random_choice(self):
        vals = np.reshape([0, np.nan, 2, 3], [2, 2])
        output = gridpp.neighbourhood(vals, 0, gridpp.RandomChoice)
        np.testing.assert_array_almost_equal(output, vals)
        output = gridpp.neighbourhood(vals, 1, gridpp.RandomChoice)
        for i in range(2):
            for j in range(2):
                assert output[i, j] in [0, 2, 3]

    def test_random_choice_only_missing(self):
        vals = np.nan * np.zeros([10, 10])
        output = gridpp.neighbourhood(vals, 3, gridpp.RandomChoice)
        assert np.isnan(output).all()


class TestConsistency:
    def test_fast_vs_brute(self):
        rng = np.random.default_rng(1000)
        x = rng.random((40, 50)).astype(np.float32)
        x[rng.random((40, 50)) < 0.2] = np.nan
        for h in [0, 1, 3, 7]:
            for stat in [gridpp.Mean, gridpp.Min, gridpp.Max, gridpp.Sum,
                         gridpp.Count]:
                fast = gridpp.neighbourhood(x, h, stat)
                brute = gridpp.neighbourhood_brute_force(x, h, stat)
                np.testing.assert_allclose(fast, brute, rtol=1e-5, atol=1e-5)

    def test_3d(self):
        rng = np.random.default_rng(1000)
        v2 = rng.random((50, 50)).astype(np.float32)
        v3 = np.repeat(v2[:, :, None], 5, axis=2)
        for halfwidth in [0, 1, 5]:
            for func in BOTH:
                out2 = func(v2, halfwidth, gridpp.Mean)
                out3 = func(v3, halfwidth, gridpp.Mean)
                np.testing.assert_array_almost_equal(out2, out3, 5)

    def test_overflow(self):
        n = int(1e3)
        vals = np.array(np.arange(1, n) ** 3, dtype=np.float64)
        vals = np.expand_dims(vals, 1)
        output = gridpp.neighbourhood(vals, 0, gridpp.Mean)
        np.testing.assert_array_almost_equal(
            np.zeros(vals.shape), output / vals - 1, 6)


class TestQuantile:
    def test_quantile(self):
        out = gridpp.neighbourhood_quantile(values, 0.5, 1)
        assert out[2][2] == 12.5
        out = gridpp.neighbourhood_quantile(values, 0, 1)
        assert out[2][2] == 6
        out = gridpp.neighbourhood_quantile(values, 1, 1)
        assert out[2][2] == 18

    def test_quantile_vs_brute_median(self):
        rng = np.random.default_rng(3)
        x = rng.random((30, 30)).astype(np.float32)
        q = gridpp.neighbourhood_quantile(x, 0.5, 2)
        m = gridpp.neighbourhood_brute_force(x, 2, gridpp.Median)
        np.testing.assert_allclose(q, m, atol=1e-6)

    def test_quantile_3d(self):
        rng = np.random.default_rng(4)
        x3 = rng.random((10, 10, 4)).astype(np.float32)
        out = gridpp.neighbourhood_quantile(x3, 0.5, 1)
        assert out.shape == (10, 10)

    def test_invalid(self):
        with pytest.raises(ValueError):
            gridpp.neighbourhood_quantile(values, 1.5, 1)
        with pytest.raises(ValueError):
            gridpp.neighbourhood_quantile(values, 0.5, -1)


class TestQuantileFast:
    def test_reference_golden(self):
        # Golden values from reference tests/test_neighbourhood_quantile_fast.py
        thresholds = gridpp.get_neighbourhood_thresholds(values, 100)
        output = np.array(
            gridpp.neighbourhood_quantile_fast(values, 0.5, 1, thresholds))
        assert output[2][2] == 12    # approximation artifact; exact is 12.5
        assert output[2][3] == 12.5  # approximation artifact; exact is 13

        output = np.array(gridpp.neighbourhood_quantile_fast(
            np.full([50, 50], np.nan), 0.5, 1, thresholds))
        assert np.isnan(output).all()

        output = np.array(gridpp.neighbourhood_quantile_fast(
            np.zeros([50, 50]), 0.5, 1, thresholds))
        assert (output == 0).all()

    def test_single_threshold(self):
        field = np.reshape(np.arange(9), [3, 3])
        for halfwidth in [0, 1, 2]:
            output = gridpp.neighbourhood_quantile_fast(
                field, 0.9, halfwidth, [0])
            np.testing.assert_array_equal(output, np.zeros([3, 3]))

    def test_nan_quantile_field(self):
        field = np.ones([5, 5])
        output = gridpp.neighbourhood_quantile_fast(field, np.nan, 1, [0, 1])
        assert np.isnan(output).all()

    def test_missing_block(self):
        empty = np.zeros([5, 5])
        empty[0:3, 0:3] = np.nan
        output = gridpp.neighbourhood_quantile_fast(empty, 0.5, 1, [0, 1])
        assert np.isnan(np.array(output)[0:2, 0:2]).all()

    def test_quantile_field(self):
        rng = np.random.default_rng(6)
        x = rng.random((10, 10)).astype(np.float32)
        qfield = np.full((10, 10), 0.5, np.float32)
        thresholds = gridpp.get_neighbourhood_thresholds(x, 10)
        out_scalar = gridpp.neighbourhood_quantile_fast(x, 0.5, 1, thresholds)
        out_field = gridpp.neighbourhood_quantile_fast(x, qfield, 1, thresholds)
        np.testing.assert_allclose(out_scalar, out_field, atol=1e-6)

    def test_ens(self):
        rng = np.random.default_rng(8)
        x3 = rng.random((10, 10, 5)).astype(np.float32)
        thresholds = gridpp.get_neighbourhood_thresholds(x3, 10)
        out = gridpp.neighbourhood_quantile_fast(x3, 0.5, 1, thresholds)
        assert out.shape == (10, 10)
        assert np.isfinite(out).all()

    def test_invalid_quantile(self):
        with pytest.raises(ValueError):
            gridpp.neighbourhood_quantile_fast(values, 1.5, 1, [1, 2])
        with pytest.raises(ValueError):
            gridpp.neighbourhood_quantile_fast(
                values, np.full((5, 5), 2.0), 1, [1, 2])
        with pytest.raises(ValueError):
            gridpp.neighbourhood_quantile_fast(
                values, np.full((3, 3), 0.5), 1, [1, 2])

    def test_empty_thresholds(self):
        out = gridpp.neighbourhood_quantile_fast(values, 0.5, 1, [])
        assert np.isnan(out).all()


class TestThresholds:
    def test_basic(self):
        out = gridpp.get_neighbourhood_thresholds(values, 5)
        assert len(out) > 0
        with pytest.raises(ValueError):
            gridpp.get_neighbourhood_thresholds(values, 0)


# --- device op (ops.neighbourhood) vs an independent numpy window loop ----
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gridpp_tpu import native  # noqa: E402
from gridpp_tpu.constants import Statistic  # noqa: E402
from gridpp_tpu.ops import neighbourhood as nops  # noqa: E402


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def _np_window(x, h, stat):
    """Windowed statistic over the last two axes by an explicit loop over
    the (2h+1)^2 offsets, in float64, with NaN = missing and the window
    clipped at the domain edge."""
    ny, nx = x.shape[-2:]
    pad = [(0, 0)] * (x.ndim - 2) + [(h, h), (h, h)]
    valid = np.pad(np.isfinite(x), pad, constant_values=False)
    xv = np.pad(np.where(np.isfinite(x), x, 0).astype(np.float64), pad)
    s = np.zeros(x.shape, np.float64)
    s2 = np.zeros(x.shape, np.float64)
    c = np.zeros(x.shape, np.float64)
    lo = np.full(x.shape, np.inf)
    hi = np.full(x.shape, -np.inf)
    for dy in range(2 * h + 1):
        for dx in range(2 * h + 1):
            v = xv[..., dy:dy + ny, dx:dx + nx]
            m = valid[..., dy:dy + ny, dx:dx + nx]
            s += v
            s2 += v * v
            c += m
            lo = np.where(m, np.minimum(lo, v), lo)
            hi = np.where(m, np.maximum(hi, v), hi)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(c > 0, s / c, np.nan)
        var = np.where(c > 0, s2 / c, np.nan) - mean * mean
    return {
        Statistic.Mean: mean,
        Statistic.Sum: np.where(c > 0, s, np.nan),
        Statistic.Count: c,
        Statistic.Min: np.where(c > 0, lo, np.nan),
        Statistic.Max: np.where(c > 0, hi, np.nan),
        Statistic.Variance: var,
        Statistic.Std: np.sqrt(var),
    }[stat]


def _device(x, h, stat):
    return np.asarray(nops.neighbourhood(jnp.asarray(x), h, int(stat)))


@pytest.mark.parametrize("stat", [Statistic.Mean, Statistic.Sum,
                                  Statistic.Count])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((300, 129), 1), ((31, 31), 0),
                                     ((256, 129), 7), ((160, 128), 3),
                                     ((256, 300), 7)])
def test_device_stencil_matches_loop(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    np.testing.assert_allclose(_device(x, h, stat), _np_window(x, h, stat),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("stat", [Statistic.Min, Statistic.Max])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((300, 129), 1), ((31, 31), 0),
                                     ((64, 64), 5), ((256, 129), 7),
                                     ((160, 128), 3)])
def test_device_minmax_matches_loop(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    np.testing.assert_allclose(_device(x, h, stat), _np_window(x, h, stat),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stat", [Statistic.Std, Statistic.Variance])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((256, 300), 7), ((31, 31), 0)])
def test_device_var_matches_loop(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    np.testing.assert_allclose(_device(x, h, stat), _np_window(x, h, stat),
                               rtol=2e-5, atol=2e-3)


def test_device_all_nan():
    x = np.full((20, 30), np.nan, np.float32)
    assert np.isnan(_device(x, 2, Statistic.Mean)).all()
    np.testing.assert_array_equal(_device(x, 2, Statistic.Count),
                                  np.zeros(x.shape, np.float32))


@pytest.mark.parametrize("shape,h", [((40, 60, 4), 3), ((17, 250, 2), 7),
                                     ((160, 130, 2), 1), ((31, 31, 6), 0)])
@pytest.mark.parametrize("stat", [Statistic.Mean, Statistic.Count,
                                  Statistic.Min, Statistic.Max])
def test_device_member_stack_matches_per_member(shape, h, stat):
    """A (Y, X, E) member field smoothed as one (E, Y, X) stencil call,
    the way EnsiPipeline does it, equals smoothing each member alone."""
    x = _field(shape, seed=int(stat) + h)
    out = np.moveaxis(_device(np.moveaxis(x, 2, 0), h, stat), 0, 2)
    ref = np.stack([_np_window(x[:, :, k], h, stat)
                    for k in range(shape[2])], axis=2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def _qf_device(x, q, h, thresholds):
    return np.asarray(nops.neighbourhood_quantile_fast(
        jnp.asarray(x), jnp.float32(q), h, jnp.asarray(thresholds)))


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape,h,t", [((40, 60), 3, 11), ((17, 140), 7, 5),
                                       ((33, 33), 2, 20), ((24, 24), 0, 7),
                                       ((64, 130), 7, 11),
                                       ((56, 128), 3, 5)])
def test_device_quantile_fast_matches_native(q, shape, h, t):
    """Device threshold-CDF quantile vs the C++ host kernel."""
    x = _field(shape, seed=h + t)
    thresholds = np.quantile(x[np.isfinite(x)],
                             np.linspace(0, 1, t)).astype(np.float32)
    ref = native.nb_quantile_fast(x, h, thresholds, None, q)
    np.testing.assert_allclose(_qf_device(x, q, h, thresholds), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [float(np.float32(1.0 / 3.0)), 0.5, 0.25,
                               float(np.float32(2.0 / 9.0))])
def test_device_quantile_fast_exact_cdf_ties(q):
    """q landing EXACTLY on attainable cdf values (s/c ratios): the
    bracket search must agree with the C++ kernel bit for bit, or the
    inverse CDF picks a different bracket and jumps a whole threshold."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 5, (30, 40)).astype(np.float32)
    x[4, 7] = np.nan  # odd window counts around the hole
    thresholds = np.arange(5, dtype=np.float32)
    ref = native.nb_quantile_fast(x, 1, thresholds, None, q)
    np.testing.assert_array_equal(_qf_device(x, q, 1, thresholds), ref)


def test_device_quantile_fast_all_nan_region():
    x = _field((40, 50), seed=3)
    x[10:20, 10:30] = np.nan
    thresholds = np.linspace(-30, 30, 9).astype(np.float32)
    ref = native.nb_quantile_fast(x, 2, thresholds, None, 0.5)
    np.testing.assert_allclose(_qf_device(x, 0.5, 2, thresholds), ref,
                               rtol=1e-5, atol=1e-5)


def test_device_vmap_matches_batched_call():
    """jax.vmap over the 2-D op equals the op on the stacked array."""
    x = jnp.asarray(np.stack([_field((24, 40), seed=s) for s in (1, 2)]))
    for stat in (Statistic.Mean, Statistic.Max):
        out = jax.vmap(lambda a, s=int(stat): nops.neighbourhood(a, 3, s))(x)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(nops.neighbourhood(x, 3, int(stat))),
            rtol=1e-6, atol=1e-6)
    thr = jnp.linspace(-30, 30, 9, dtype=jnp.float32)
    out = jax.vmap(lambda a: nops.neighbourhood_quantile_fast(
        a, 0.5, 3, thr))(x)
    ref = [nops.neighbourhood_quantile_fast(x[k], 0.5, 3, thr)
           for k in range(2)]
    np.testing.assert_allclose(np.asarray(out), np.stack(ref), rtol=1e-6,
                               atol=1e-6)


def test_host_api_min_max_score_quantile_fast():
    """The host-pinned API runs the device ops on XLA:CPU for Min/Max,
    neighbourhood_score and quantile_fast."""
    x = _field((30, 40), seed=11)
    for stat in (Statistic.Max, Statistic.Min, Statistic.Mean):
        np.testing.assert_allclose(gridpp.neighbourhood(x, 7, int(stat)),
                                   _np_window(x, 7, stat), rtol=1e-5,
                                   atol=1e-4)
    lats, lons = np.meshgrid(np.linspace(0, 1, 10), np.linspace(0, 1, 10),
                             indexing="ij")
    grid = gridpp.Grid(lats, lons)
    pts = gridpp.Points(np.linspace(0.1, 0.9, 5), np.linspace(0.1, 0.9, 5))
    s = gridpp.neighbourhood_score(
        grid, pts,
        np.random.default_rng(0).random((10, 10)).astype(np.float32),
        np.ones(5, np.float32), 3, gridpp.Ets, 0.5)
    assert s.shape == (10, 10)
    thr = np.linspace(0, 1, 7).astype(np.float32)
    assert gridpp.neighbourhood_quantile_fast(x, 0.5, 3, thr).shape == x.shape


def test_host_api_runs_on_cpu_device():
    """Every host API call is pinned to this process's CPU device."""
    from gridpp_tpu.api import _common
    assert _common.cpu_device().platform == "cpu"
    with jax.default_device(_common.cpu_device()):
        assert _common.on_host()
    assert gridpp.neighbourhood.__wrapped_host_pin__


def test_ensi_pipeline_smoothing_matches_host():
    """EnsiPipeline with halfwidth > 0 smooths the member stack in one
    stencil call; the analysis equals the host API run on members
    smoothed one by one."""
    rng = np.random.default_rng(21)
    n, n_obs, e, h = 24, 40, 3, 2
    lats, lons = np.meshgrid(np.linspace(55, 56, n), np.linspace(5, 6, n),
                             indexing="ij")
    grid = gridpp.Grid(lats, lons)
    pts = gridpp.Points(rng.uniform(55, 56, n_obs), rng.uniform(5, 6, n_obs),
                        np.zeros(n_obs), np.zeros(n_obs))
    bg3 = rng.normal(280, 3, (n, n, e)).astype(np.float32)
    smooth = np.stack([gridpp.neighbourhood(bg3[:, :, k], h, gridpp.Mean)
                       for k in range(e)], axis=2)
    idx = grid.nearest_map(pts.lats, pts.lons)
    pb3 = smooth.reshape(-1, e)[idx]
    pobs = (pb3.mean(axis=1) + rng.normal(0, 1, n_obs)).astype(np.float32)
    psig = np.full(n_obs, 1.0, np.float32)
    structure = gridpp.BarnesStructure(30000.0)
    want = gridpp.optimal_interpolation_ensi(grid, smooth, pts, pobs, psig,
                                             pb3, structure, 5)
    epipe = gridpp.EnsiPipeline(grid, pts, structure, halfwidth=h,
                                statistic=gridpp.Mean, max_points=5)
    np.testing.assert_allclose(epipe(bg3, pobs, psig), want, atol=1e-2)
