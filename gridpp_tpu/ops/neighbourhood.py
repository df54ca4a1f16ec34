"""Neighbourhood (moving-window) statistics as XLA stencil ops.

Data-parallel redesign of reference src/api/neighbourhood.cpp:
- Mean/Sum/Count: the reference builds a double-precision summed-area table
  serially then does 4-corner lookups (neighbourhood.cpp:45-144). Here the
  window sum is two separable 1-D `lax.reduce_window` adds - exact local
  tree-sums (no global accumulation error, matching the double-SAT's output
  precision) and fully parallel.
- Min/Max: the reference uses a row-sliver decomposition (146-210); here
  a masked separable reduce_window min/max.
- Std/Variance: two Mean passes, sqrt(E[x^2]-E[x]^2) with the reference's
  exact (unclamped) arithmetic (211-235).
- Quantile/Median/other: windowed gather + the order-statistic quantile
  (neighbourhood_brute_force, 556-654).
- neighbourhood_quantile_fast: per-threshold indicator CDF fields smoothed
  with the Mean stencil, then per-cell interpolation across thresholds
  (296-527). The T thresholds ride a leading batch axis.

All functions treat NaN as missing with the reference's skip semantics and
are jittable; halfwidth/statistic are static.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import Statistic
from .stats import nan_quantile, nan_statistic

__all__ = [
    "window_sum", "window_count", "window_min", "window_max",
    "neighbourhood", "neighbourhood_brute_force", "neighbourhood_quantile",
    "neighbourhood_quantile_fast", "interp_quantile_from_cdf",
]


def _reduce_window_2d(x, h: int, op, init):
    """Separable (2h+1)x(2h+1) moving-window reduction over last 2 axes.

    Edges are clipped (pad contributes the identity), matching the
    reference's window intersection with the domain.
    """
    if h == 0:
        return x
    nd = x.ndim
    # h beyond the grid extent is equivalent after edge clipping
    hy = min(h, x.shape[-2] - 1)
    hx = min(h, x.shape[-1] - 1)
    dims1 = (1,) * (nd - 2) + (2 * hy + 1, 1)
    dims2 = (1,) * (nd - 2) + (1, 2 * hx + 1)
    pad = ((0, 0),) * (nd - 2) + ((hy, hy), (0, 0))
    y = lax.reduce_window(x, init, op, dims1, (1,) * nd, pad)
    pad = ((0, 0),) * (nd - 2) + ((0, 0), (hx, hx))
    return lax.reduce_window(y, init, op, dims2, (1,) * nd, pad)


def window_sum(x, h: int):
    """NaN-skipping moving-window sum (invalid cells contribute 0)."""
    xs = jnp.where(jnp.isfinite(x), x, 0).astype(jnp.float32)
    return _reduce_window_2d(xs, h, lax.add, jnp.float32(0))


def window_count(x, h: int):
    """Moving-window count of valid cells."""
    m = jnp.isfinite(x).astype(jnp.float32)
    return _reduce_window_2d(m, h, lax.add, jnp.float32(0))


def window_min(x, h: int):
    xs = jnp.where(jnp.isfinite(x), x, jnp.inf).astype(jnp.float32)
    out = _reduce_window_2d(xs, h, lax.min, jnp.float32(jnp.inf))
    return jnp.where(jnp.isposinf(out), jnp.nan, out)


def window_max(x, h: int):
    xs = jnp.where(jnp.isfinite(x), x, -jnp.inf).astype(jnp.float32)
    out = _reduce_window_2d(xs, h, lax.max, jnp.float32(-jnp.inf))
    return jnp.where(jnp.isneginf(out), jnp.nan, out)


@partial(jax.jit, static_argnames=("halfwidth", "statistic"))
def neighbourhood(input: jax.Array, halfwidth: int, statistic: int):
    """Fast moving-window statistic over the last two axes (Y, X).

    Leading axes (e.g. the per-threshold batch of quantile_fast) broadcast.
    Mirrors neighbourhood.cpp:28-241 dispatch.
    """
    statistic = int(statistic)
    h = int(halfwidth)
    if statistic in (Statistic.Mean, Statistic.Sum, Statistic.Count):
        s = window_sum(input, h)
        c = window_count(input, h)
        if statistic == Statistic.Count:
            return c
        val = s / jnp.maximum(c, 1) if statistic == Statistic.Mean else s
        return jnp.where(c > 0, val, jnp.nan)
    if statistic == Statistic.Min:
        return window_min(input, h)
    if statistic == Statistic.Max:
        return window_max(input, h)
    if statistic in (Statistic.Std, Statistic.Variance):
        mean = neighbourhood(input, h, Statistic.Mean)
        if h == 0:
            # one-cell windows: E[x^2]-E[x]^2 would leave only rounding
            # noise, negative for about half the cells once XLA fuses the
            # product into the subtraction
            var = mean - mean
        else:
            mean2 = neighbourhood(input * input, h, Statistic.Mean)
            # unclamped, like neighbourhood.cpp:211-235
            var = mean2 - mean * mean
        return jnp.sqrt(var) if statistic == Statistic.Std else var
    return neighbourhood_brute_force(input, h, statistic)


def _window_stack(x, h: int):
    """Stack the (2h+1)^2 shifted copies of x along a new last axis.

    Out-of-domain positions are NaN (skipped by the nan-aware reducers),
    reproducing the brute-force edge clipping. h is clamped to the grid
    extent: larger windows are equivalent after edge clipping.
    """
    h = min(h, max(x.shape[-2], x.shape[-1]) - 1)
    w = 2 * h + 1
    lead = x.shape[:-2]
    ny, nx = x.shape[-2], x.shape[-1]
    pad = ((0, 0),) * (len(lead)) + ((h, h), (h, h))
    xp = jnp.pad(x.astype(jnp.float32), pad, constant_values=jnp.nan)
    # One exact gather op regardless of window size: flat indices into the
    # padded plane for every (cell, window-slot) pair.
    dy = jnp.arange(w, dtype=jnp.int32)
    dx = jnp.arange(w, dtype=jnp.int32)
    yy = jnp.arange(ny, dtype=jnp.int32)[:, None, None, None] + dy[None, None, :, None]
    xx = jnp.arange(nx, dtype=jnp.int32)[None, :, None, None] + dx[None, None, None, :]
    flat = (yy * (nx + 2 * h) + xx).reshape(ny, nx, w * w)
    out = jnp.take(xp.reshape(lead + (-1,)), flat, axis=-1)
    return out


@partial(jax.jit, static_argnames=("halfwidth", "statistic"))
def neighbourhood_brute_force(input: jax.Array, halfwidth: int,
                              statistic: int):
    """Windowed gather + exact statistic (neighbourhood.cpp:556-654).

    input may be (..., Y, X) or (..., Y, X, E) with ens=True handled by the
    caller flattening E into the window axis.
    """
    stack = _window_stack(input, int(halfwidth))
    return nan_statistic(stack, int(statistic), axis=-1)


@partial(jax.jit, static_argnames=("halfwidth",))
def neighbourhood_quantile(input: jax.Array, quantile, halfwidth: int):
    """Exact windowed quantile via per-cell sorted order statistics."""
    stack = _window_stack(input, int(halfwidth))
    return nan_quantile(stack, quantile, axis=-1)


@partial(jax.jit, static_argnames=("halfwidth",))
def neighbourhood_quantile_ens(input: jax.Array, quantile, halfwidth: int):
    """(Y, X, E) variant: window gathers across the ensemble axis too."""
    x = jnp.moveaxis(input, -1, 0)  # (E, Y, X)
    stack = _window_stack(x, int(halfwidth))  # (E, Y, X, W)
    stack = jnp.moveaxis(stack, 0, -2)  # (Y, X, E, W)
    flat = stack.reshape(stack.shape[:-2] + (-1,))
    return nan_quantile(flat, quantile, axis=-1)


@partial(jax.jit, static_argnames=("halfwidth", "statistic"))
def neighbourhood_brute_force_ens(input: jax.Array, halfwidth: int,
                                  statistic: int):
    x = jnp.moveaxis(input, -1, 0)
    stack = _window_stack(x, int(halfwidth))
    stack = jnp.moveaxis(stack, 0, -2)
    flat = stack.reshape(stack.shape[:-2] + (-1,))
    return nan_statistic(flat, int(statistic), axis=-1)


def interp_quantile_from_cdf(q, cdf, thresholds):
    """Per-cell piecewise-linear inverse-CDF (neighbourhood.cpp:367-404).

    cdf: (Y, X, T) non-decreasing along T (values in [0,1], NaN=missing);
    thresholds: (T,); q: scalar or (Y, X). Thin wrapper over the
    threshold-leading layout (see _interp_quantile_tyx).
    """
    return _interp_quantile_tyx(q, jnp.moveaxis(cdf, -1, 0), thresholds)


def _interp_quantile_tyx(q, cdf, thresholds):
    """Inverse-CDF with cdf in (T, Y, X) layout.

    The (Y, X) axes stay minor-most and every reduction runs over the
    small leading T axis. Replicates gridpp::interpolate's flat-interval
    rules plus the two exact-edge special cases.
    """
    t = thresholds.shape[0]
    q = jnp.asarray(q, dtype=cdf.dtype)
    qs = jnp.broadcast_to(q, cdf.shape[1:])  # (Y, X)
    left = jnp.sum(cdf < qs[None], axis=0)    # first index with cdf >= q
    right = jnp.sum(cdf <= qs[None], axis=0)  # first index with cdf > q
    has_exact = right > left
    i0 = jnp.where(has_exact, left, left - 1)
    i1 = jnp.where(has_exact, right - 1, right)
    i0c = jnp.clip(i0, 0, t - 1)
    i1c = jnp.clip(i1, 0, t - 1)
    # Select the bracketing CDF values/thresholds by one-hot contraction
    # over the small T axis (T masked adds instead of a per-element
    # gather over the leading axis)
    tids = jnp.arange(t, dtype=i0c.dtype)[:, None, None]  # (T, 1, 1)
    oh0 = tids == i0c[None]
    oh1 = tids == i1c[None]
    thr_col = thresholds.astype(cdf.dtype)[:, None, None]
    x0 = jnp.sum(jnp.where(oh0, cdf, 0), axis=0)
    x1 = jnp.sum(jnp.where(oh1, cdf, 0), axis=0)
    y0 = jnp.sum(jnp.where(oh0, thr_col, 0), axis=0)
    y1 = jnp.sum(jnp.where(oh1, thr_col, 0), axis=0)
    flat = x0 == x1
    both_edge = (i0 == 0) & (i1 == t - 1)
    y_flat = jnp.where(both_edge, (y0 + y1) / 2,
                       jnp.where(i0 == 0, y1,
                                 jnp.where(i1 == t - 1, y0, (y0 + y1) / 2)))
    dx = jnp.where(flat, 1, x1 - x0)
    y_lin = y0 + (y1 - y0) * (qs - x0) / dx
    y = jnp.where(flat, y_flat, y_lin)
    y = jnp.where(qs > cdf[t - 1], thresholds[t - 1], y)
    y = jnp.where(qs < cdf[0], thresholds[0], y)
    # Exact-edge special cases (neighbourhood.cpp:396-401)
    y = jnp.where((qs == 1) & (cdf[0] == 1), thresholds[0], y)
    y = jnp.where((qs == 0) & (cdf[t - 1] == 0), thresholds[t - 1], y)
    missing = jnp.any(~jnp.isfinite(cdf), axis=0) | ~jnp.isfinite(qs)
    return jnp.where(missing, jnp.nan, y)


@partial(jax.jit, static_argnames=("halfwidth",))
def neighbourhood_quantile_fast(input: jax.Array, quantile, halfwidth: int,
                                thresholds: jax.Array):
    """Threshold-CDF approximate windowed quantile (neighbourhood.cpp:302-409).

    input: (Y, X) or (Y, X, E). For each threshold, the fraction of valid
    values <= threshold is computed per cell, smoothed with the Mean
    stencil, clamped to [0,1], then the quantile is read off by per-cell
    interpolation across thresholds.
    """
    ens = input.ndim == 3
    t = thresholds.shape[0]
    valid = jnp.isfinite(input)
    # (T, Y, X[, E]) indicator fractions per cell
    le = input[None] <= thresholds.reshape((t,) + (1,) * input.ndim)
    if ens:
        num = jnp.sum(le & valid[None], axis=-1).astype(jnp.float32)
        den = jnp.sum(valid, axis=-1)[None].astype(jnp.float32)
        temp = jnp.where(den > 0, num / jnp.maximum(den, 1), jnp.nan)
    else:
        temp = jnp.where(valid[None], le.astype(jnp.float32), jnp.nan)
    stats = neighbourhood(temp, int(halfwidth), Statistic.Mean)  # (T, Y, X)
    cdf = jnp.where(jnp.isfinite(stats), jnp.clip(stats, 0.0, 1.0),
                    jnp.nan)  # stays threshold-leading: no transpose
    return _interp_quantile_tyx(quantile, cdf, thresholds)
