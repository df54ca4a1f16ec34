"""Optimal interpolation device kernels.

Data-parallel redesign of reference src/api/oi.cpp: the reference loops over
gridpoints, querying an R-tree and solving a small dense system per point
(oi.cpp:221-341). Here the per-gridpoint work — structure-function rho
evaluation, top-max_points selection, S x S covariance assembly, solve,
increment clamping — is one fused batched XLA program over blocks of
gridpoints.

Two selection modes:
- `oi_block`: candidates come from a host spatial query (padded lists) —
  used when the observation set is too large to sweep densely.
- `oi_block_dense`: FULLY on-device selection. For moderate observation
  counts the kernel evaluates rho against every observation and takes the
  top max_points directly. Since every structure function already zeroes
  rho beyond its localization distance, `rho > 0` reproduces the
  reference's radius query exactly — and no candidate arrays ever cross
  the host-device link.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["oi_block", "oi_block_dense", "oi_block_from_candidates",
           "make_oi_kernel", "make_oi_gather_kernel",
           "make_oi_dense_kernel", "make_oi_select_sweep"]


def _select_top(rho, valid, s_cap: int):
    """Top-s_cap candidates by rho among valid ones (oi.cpp:262-281)."""
    neg = jnp.where(valid, rho, -jnp.inf)
    vals, sel = jax.lax.top_k(neg, s_cap)  # (B, S)
    sel_valid = jnp.isfinite(vals)
    return vals, sel, sel_valid


def _gj_solve_batch_last(a, b):
    """Solve a[:, :, i] @ x[:, i] = b[:, i] for every batch column i.

    a: (S, S, B), b: (S, B). Unrolled Gauss-Jordan without pivoting —
    valid because the OI system is a correlation matrix plus a positive
    diagonal ridge (SPD), and masked-out rows are identity rows. The
    batch-LAST layout makes every step full-width elementwise work over
    the gridpoint batch. It was chosen over a batched `linalg.solve` on
    a TPU; whether it still wins on the GPU is an open question
    (ROADMAP 1.3).
    """
    s = a.shape[0]
    m = jnp.concatenate([a, b[:, None, :]], axis=1)  # (S, S+1, B)
    for k in range(s):
        row = m[k] / m[k, k]  # (S+1, B)
        m = m - m[:, k][:, None, :] * row[None, :, :]
        m = m.at[k].set(row)
    return m[:, s]  # (S, B)


def _solve_selected(structure, sel_fields, lg, sel_valid, l_obs, l_y, l_r,
                    background, bvariance, allow_extrapolation: bool):
    """Shared OI tail: S x S assembly, solve, clamp (oi.cpp:289-341).

    All (S, S)-shaped work runs in batch-last layout (see
    _gj_solve_batch_last): the small S axes lead and the gridpoint batch
    is the minor axis.
    """
    s_cap = lg.shape[1]
    ft = {key: v.T for key, v in sel_fields.items()}  # (S, B)
    pi = {key: v[:, None, :] for key, v in ft.items()}
    pj = {key: v[None, :, :] for key, v in ft.items()}
    lp = structure.corr_jnp(pi, pj).astype(jnp.float32)  # (S, S, B)

    sv = sel_valid.T  # (S, B)
    pair_valid = sv[:, None, :] & sv[None, :, :]
    eye = jnp.eye(s_cap, dtype=jnp.float32)[:, :, None]
    ridge = jnp.where(sv, l_r.T, 1.0)[:, None, :] * eye
    a_mat = jnp.where(pair_valid, lp, 0.0) + ridge
    a_mat = jnp.where(pair_valid | (eye > 0), a_mat, 0.0)

    x = _gj_solve_batch_last(a_mat, lg.T.astype(jnp.float32)).T  # (B, S)

    innov = jnp.where(sel_valid, l_obs - l_y, 0.0)
    increment = jnp.sum(x * innov, axis=1)
    a_scalar = jnp.sum(x * lg, axis=1)

    if not allow_extrapolation:
        big = jnp.float32(np.inf)
        max_inc = jnp.max(jnp.where(sel_valid, l_obs - l_y, -big), axis=1)
        min_inc = jnp.min(jnp.where(sel_valid, l_obs - l_y, big), axis=1)
        c1 = (max_inc > 0) & (increment > max_inc)
        c2 = ~c1 & (max_inc < 0) & (increment > 0)
        c3 = ~c1 & ~c2 & (min_inc < 0) & (increment < min_inc)
        c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (increment < 0)
        increment = jnp.where(c1 | c2, max_inc,
                              jnp.where(c3 | c4, min_inc, increment))

    any_valid = jnp.any(sel_valid, axis=1)
    ok = any_valid & jnp.isfinite(background)
    out = jnp.where(ok, background + increment, background)
    avar = jnp.where(ok, bvariance * (1 - a_scalar), bvariance)
    return out, avar


def oi_block(structure, p1_fields, cand_fields, cand_rho_valid,
             background, bvariance, obs, obs_y, ratios,
             max_points: int, allow_extrapolation: bool):
    """Solve OI for a block of gridpoints with host-provided candidates.

    p1_fields: dict of (B, 1) arrays (x,y,z,elev,laf[,h,v,w]).
    cand_fields: dict of (B, K) arrays for candidate observations, plus
    obs/obs_y/ratios (B, K). cand_rho_valid: (B, K) mask of candidates in
    range with valid obs values.
    """
    k = obs.shape[1]
    s_cap = min(max_points, k) if max_points > 0 else k

    rho = structure.corr_background_jnp(p1_fields, cand_fields)  # (B, K)
    valid = cand_rho_valid & (rho > 0)

    vals, sel, sel_valid = _select_top(rho, valid, s_cap)
    lg = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)  # (B, S)

    sel_fields = {key: jnp.take_along_axis(cand_fields[key], sel, axis=1)
                  for key in cand_fields}
    l_obs = jnp.take_along_axis(obs, sel, axis=1)
    l_y = jnp.take_along_axis(obs_y, sel, axis=1)
    l_r = jnp.take_along_axis(ratios, sel, axis=1)
    return _solve_selected(structure, sel_fields, lg, sel_valid, l_obs,
                           l_y, l_r, background, bvariance,
                           allow_extrapolation)


def oi_block_dense(structure, p1_fields, obs_fields, background, bvariance,
                   obs, obs_y, ratios, max_points: int,
                   allow_extrapolation: bool):
    """Fully on-device OI: rho against ALL observations, then top-k.

    p1_fields: dict of (B, 1) arrays; obs_fields: dict of (P,) arrays;
    obs/obs_y/ratios: (P,).
    """
    p = obs.shape[0]
    s_cap = min(max_points, p) if max_points > 0 else p
    o2 = {key: v[None, :] for key, v in obs_fields.items()}
    rho = structure.corr_background_jnp(p1_fields, o2)  # (B, P)
    valid = rho > 0  # localization is already inside rho

    vals, sel, sel_valid = _select_top(rho, valid, s_cap)
    lg = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)

    sel_fields = {key: jnp.take(obs_fields[key], sel, axis=0)
                  for key in obs_fields}
    l_obs = jnp.take(obs, sel, axis=0)
    l_y = jnp.take(obs_y, sel, axis=0)
    l_r = jnp.take(ratios, sel, axis=0)
    return _solve_selected(structure, sel_fields, lg, sel_valid, l_obs,
                           l_y, l_r, background, bvariance,
                           allow_extrapolation)


def oi_block_from_candidates(structure, cand_sel, cand_rho, cand_valid,
                             obs_fields, background, bvariance, obs, obs_y,
                             ratios, max_points: int,
                             allow_extrapolation: bool):
    """OI with a PRECOMPUTED geometric candidate shortlist.

    The top-rho shortlist (cand_sel/cand_rho/cand_valid, all (B, K)) is
    geometry-only — it depends on the grid, the obs network and the
    structure function, none of which change between forecast cycles — so
    it is computed once (make_oi_select_sweep) and reused every call.
    Per call only obs *values* change: candidates whose obs/background are
    invalid this cycle are masked here and the final top-max_points
    re-selected among the survivors (exact vs the reference pre-filter at
    oi.cpp:250-260 as long as the shortlist has >= max_points valid
    entries; K > max_points provides the slack).
    """
    k = cand_sel.shape[1]
    s_cap = min(max_points, k) if max_points > 0 else k
    valid = (cand_valid
             & jnp.isfinite(jnp.take(obs, cand_sel, axis=0))
             & jnp.isfinite(jnp.take(obs_y, cand_sel, axis=0)))

    vals, sub, sel_valid = _select_top(cand_rho, valid, s_cap)
    lg = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
    g = jnp.take_along_axis(cand_sel, sub, axis=1)

    sel_fields = {key: jnp.take(obs_fields[key], g, axis=0)
                  for key in obs_fields}
    l_obs = jnp.take(obs, g, axis=0)
    l_y = jnp.take(obs_y, g, axis=0)
    l_r = jnp.take(ratios, g, axis=0)
    return _solve_selected(structure, sel_fields, lg, sel_valid, l_obs,
                           l_y, l_r, background, bvariance,
                           allow_extrapolation)


def make_oi_select_sweep(structure, k_cap: int, block: int):
    """One-dispatch geometric candidate selection over the whole grid.

    Returns a jitted kernel (p1_fields {(N,) arrays}, obs_fields
    {(P,) arrays}) -> (sel (N, K) int32, rho (N, K) f32, valid (N, K)
    bool): for every gridpoint, the K highest-rho observations under the
    structure function (rho > 0 reproduces the reference's radius query
    since every kernel zeroes rho beyond its localization distance).
    """
    cache, hit = _kernel_cache(structure, "_oi_select_sweep_cache",
                               (int(k_cap), int(block)))
    if hit is not None:
        return hit

    @jax.jit
    def kernel(p1_fields, obs_fields):
        n = next(iter(p1_fields.values())).shape[0]
        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v):
            return jnp.concatenate(
                [v, jnp.full((pad,), jnp.nan, v.dtype)]) if pad else v

        p1s = {k: pad_to(v).reshape(nb, block, 1)
               for k, v in p1_fields.items()}
        o2 = {k: v[None, :] for k, v in obs_fields.items()}

        def body(p1c):
            rho = structure.corr_background_jnp(p1c, o2)  # (B, P)
            vals, sel, sel_valid = _select_top(rho, rho > 0, k_cap)
            return (sel.astype(jnp.int32),
                    jnp.where(sel_valid, vals, 0.0).astype(jnp.float32),
                    sel_valid)

        sel, rho, valid = jax.lax.map(body, p1s)
        return (sel.reshape(-1, k_cap)[:n], rho.reshape(-1, k_cap)[:n],
                valid.reshape(-1, k_cap)[:n])

    cache[(int(k_cap), int(block))] = kernel
    return kernel


def _kernel_cache(structure, name, key):
    cache = structure.__dict__.setdefault(name, {})
    return cache, cache.get(key)


def make_oi_kernel(structure, max_points: int, allow_extrapolation: bool):
    """jit-compiled host-candidate OI block solver (cached per structure)."""
    cache, hit = _kernel_cache(structure, "_oi_kernel_cache",
                               (int(max_points), bool(allow_extrapolation)))
    if hit is not None:
        return hit

    @jax.jit
    def kernel(p1_fields, cand_fields, cand_rho_valid, background,
               bvariance, obs, obs_y, ratios):
        return oi_block(structure, p1_fields, cand_fields, cand_rho_valid,
                        background, bvariance, obs, obs_y, ratios,
                        max_points, allow_extrapolation)

    cache[(int(max_points), bool(allow_extrapolation))] = kernel
    return kernel


def make_oi_dense_kernel(structure, max_points: int,
                         allow_extrapolation: bool):
    """jit-compiled dense (all-obs on device) OI block solver."""
    cache, hit = _kernel_cache(structure, "_oi_dense_kernel_cache",
                               (int(max_points), bool(allow_extrapolation)))
    if hit is not None:
        return hit

    @jax.jit
    def kernel(p1_fields, obs_fields, background, bvariance, obs, obs_y,
               ratios):
        return oi_block_dense(structure, p1_fields, obs_fields, background,
                              bvariance, obs, obs_y, ratios, max_points,
                              allow_extrapolation)

    cache[(int(max_points), bool(allow_extrapolation))] = kernel
    return kernel


def make_oi_dense_sweep(structure, max_points: int,
                        allow_extrapolation: bool, block: int):
    """Whole-grid dense OI in ONE dispatch.

    Wraps oi_block_dense in a lax.map over gridpoint chunks, so the (B, P)
    rho matrix stays bounded while the entire grid sweeps in a single XLA
    program - no per-block dispatch latency.
    """
    cache, hit = _kernel_cache(
        structure, "_oi_dense_sweep_cache",
        (int(max_points), bool(allow_extrapolation), int(block)))
    if hit is not None:
        return hit

    @jax.jit
    def kernel(p1_fields, obs_fields, background, bvariance, obs, obs_y,
               ratios):
        n = background.shape[0]
        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v):
            return jnp.concatenate(
                [v, jnp.full((pad,), jnp.nan, v.dtype)]) if pad else v

        p1s = {k: pad_to(v).reshape(nb, block, 1)
               for k, v in p1_fields.items()}
        bg = pad_to(background).reshape(nb, block)
        bv = pad_to(bvariance).reshape(nb, block)

        def body(args):
            p1c, bgc, bvc = args
            return oi_block_dense(structure, p1c, obs_fields, bgc, bvc,
                                  obs, obs_y, ratios, max_points,
                                  allow_extrapolation)

        out, avar = jax.lax.map(body, (p1s, bg, bv))
        return out.reshape(-1)[:n], avar.reshape(-1)[:n]

    cache[(int(max_points), bool(allow_extrapolation), int(block))] = kernel
    return kernel


def make_oi_shortlist_sweep(structure, max_points: int,
                            allow_extrapolation: bool, block: int):
    """Whole-grid OI from a canonical candidate shortlist in ONE dispatch.

    The accelerator serving path of the plain API (api/oi.py): selection
    order and rho come from the host-computed canonical shortlist
    (ops/canonical.py), so per call the kernel only masks candidates
    whose obs values are invalid, re-selects the top max_points among
    survivors (ties already resolved by the stored order) and solves.
    Also returns the number of STARVED gridpoints: rows whose shortlist
    was truncated (more in-range candidates exist beyond K) and which
    kept fewer than max_points valid entries this cycle — for those the
    caller must fall back to a full-depth path to preserve the
    reference's dig-deeper semantics (oi.cpp:250-281).
    """
    cache, hit = _kernel_cache(
        structure, "_oi_shortlist_sweep_cache",
        (int(max_points), bool(allow_extrapolation), int(block)))
    if hit is not None:
        return hit

    @jax.jit
    def kernel(sel, rho, valid, truncated, obs_fields, background,
               bvariance, obs, obs_y, ratios):
        n, k_cap = sel.shape
        s_cap = min(max_points, k_cap) if max_points > 0 else k_cap
        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v, fill):
            if not pad:
                return v
            return jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:], fill, v.dtype)])

        args = (pad_to(sel, 0).reshape(nb, block, k_cap),
                pad_to(rho, 0).reshape(nb, block, k_cap),
                pad_to(valid, False).reshape(nb, block, k_cap),
                pad_to(truncated, False).reshape(nb, block),
                pad_to(background, jnp.nan).reshape(nb, block),
                pad_to(bvariance, jnp.nan).reshape(nb, block))

        def body(chunk):
            selc, rhoc, valc, trc, bgc, bvc = chunk
            v = (valc
                 & jnp.take(jnp.isfinite(obs), selc, axis=0)
                 & jnp.take(jnp.isfinite(obs_y), selc, axis=0))
            nvalid = jnp.sum(v, axis=1)
            starved = trc & (nvalid < s_cap)
            vals, sub, sel_valid = _select_top(rhoc, v, s_cap)
            lg = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
            g = jnp.take_along_axis(selc, sub, axis=1)
            sel_fields = {key: jnp.take(obs_fields[key], g, axis=0)
                          for key in obs_fields}
            out, avar = _solve_selected(
                structure, sel_fields, lg, sel_valid,
                jnp.take(obs, g, axis=0), jnp.take(obs_y, g, axis=0),
                jnp.take(ratios, g, axis=0), bgc, bvc,
                allow_extrapolation)
            return out, avar, jnp.sum(starved)

        out, avar, starved = jax.lax.map(body, args)
        return (out.reshape(-1)[:n], avar.reshape(-1)[:n],
                jnp.sum(starved))

    cache[(int(max_points), bool(allow_extrapolation), int(block))] = kernel
    return kernel


def make_oi_gather_kernel(structure, max_points: int,
                          allow_extrapolation: bool):
    """Host-candidate OI block solver with the gathers INSIDE the jit.

    The host path previously gathered candidate fields with ~12 eager
    jnp ops per block before invoking the jitted solver; fusing them in
    removes the per-primitive dispatches and the materialized (B, K)
    gather intermediates. Measured at 2000^2/10k the call is
    compute-bound on the batched solve either way (the gathers are
    ~1 s of a ~40 s call), so this is a dispatch-count/allocation
    cleanup, not a speedup.
    """
    cache, hit = _kernel_cache(structure, "_oi_gather_kernel_cache",
                               (int(max_points),
                                bool(allow_extrapolation)))
    if hit is not None:
        return hit

    @jax.jit
    def kernel(p1_fields, obs_fields, cand, mask, background,
               bvariance, obs, obs_y, ratios):
        cand_fields = {k: jnp.take(v, cand, axis=0)
                       for k, v in obs_fields.items()}
        return oi_block(structure, p1_fields, cand_fields, mask,
                        background, bvariance,
                        jnp.take(obs, cand, axis=0),
                        jnp.take(obs_y, cand, axis=0),
                        jnp.take(ratios, cand, axis=0),
                        max_points, allow_extrapolation)

    cache[(int(max_points), bool(allow_extrapolation))] = kernel
    return kernel
