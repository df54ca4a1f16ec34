"""Multi-variant ensemble OI kernels (reference src/api/oi_ensi_multi.cpp).

Three schemes, each batched over blocks of gridpoints:
- ebe  ("ensemble member by ensemble member", oi_ensi_multi.cpp:329-627):
  per-member innovations; correlations from a second `background_corr`
  ensemble via Schur products of localization with normalized-anomaly
  outer products; gain lK = lr_lr inv(lR_rr + R_dd).
- ebesc (static correlations, 629-860): same innovation structure, but
  correlations purely from the structure function.
- utem ("use the ensemble mean", 862-1311): ETKF-style transform like
  oi_ensi but with correlation anomalies from `background_corr` and the
  W/w combination scaled by the ensemble std and bratios.

Padded slots use the Rinv=0 / innov=0 trick throughout.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .oi import _gj_solve_batch_last, _kernel_cache
from .oi_ensi import _inv_sqrt_ns_m, _mm, _mv

__all__ = ["make_ebe_kernel", "make_ebesc_kernel", "make_utem_kernel",
           "make_member_serve_sweep", "make_utem_serve_sweep",
           "norm_anom_jnp"]

DEFAULT_MIN_STD = 0.0013


def norm_anom_jnp(arr):
    """Device form of the normalized-anomaly transform
    (oi_ensi_multi.cpp:421-445): 1/sqrt(E-1) (v-mean)/std, zeroed for
    tiny/invalid std. arr: (N, E) all members valid."""
    e = arr.shape[1]
    mean = jnp.mean(arr, axis=1)
    std = jnp.std(arr, axis=1)
    bad = ~jnp.isfinite(mean) | ~jnp.isfinite(std) | (std <= DEFAULT_MIN_STD)
    denom = jnp.where(std == 0, 1, std)
    out = (arr - mean[:, None]) / denom[:, None] / np.sqrt(max(e - 1, 1))
    return jnp.where(bad[:, None], 0.0, out).astype(jnp.float32)


def _select(structure, p1_fields, cand_fields, cand_valid, max_points, k):
    rho = structure.corr_background_jnp(p1_fields, cand_fields)
    valid = cand_valid & (rho > 0)
    s_cap = min(max_points, k) if max_points > 0 else k
    vals, sel = jax.lax.top_k(jnp.where(valid, rho, -jnp.inf), s_cap)
    sel_valid = jnp.isfinite(vals)
    l_rho = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
    return sel, sel_valid, l_rho


def _pair_corr(structure, sel_fields):
    pi = {key: v[:, :, None] for key, v in sel_fields.items()}
    pj = {key: v[:, None, :] for key, v in sel_fields.items()}
    return structure.corr_jnp(pi, pj).astype(jnp.float32)


def _anti_extrap_member(dx, innov, sel_valid):
    """Member-wise clamp (oi_ensi_multi.cpp:583-607): dx (B,E),
    innov (B,S,E)."""
    big = jnp.float32(np.inf)
    masked = jnp.where(sel_valid[:, :, None], innov, jnp.nan)
    max_inc = jnp.max(jnp.where(jnp.isnan(masked), -big, masked), axis=1)
    min_inc = jnp.min(jnp.where(jnp.isnan(masked), big, masked), axis=1)
    c1 = (max_inc > 0) & (dx > max_inc)
    c2 = ~c1 & (max_inc < 0) & (dx > 0)
    c3 = ~c1 & ~c2 & (min_inc < 0) & (dx < min_inc)
    c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (dx < 0)
    return jnp.where(c1, max_inc,
                     jnp.where(c2, 0.0,
                               jnp.where(c3, min_inc,
                                         jnp.where(c4, 0.0, dx))))


def _member_update(structure, sel_fields, sel_valid, l_rho, l_r, l_innov,
                   background, bratios, allow_extrapolation: bool,
                   l_z=None, x_l=None):
    """Shared ebe/ebesc tail in BATCH-LAST layout.

    The (S, S) solve work keeps the small obs axes leading and the
    gridpoint batch minor (_gj_solve_batch_last, ops/oi.py).

    sel_fields: dict (B, S); sel_valid/l_rho/l_r: (B, S);
    l_innov: (B, S, E) member innovations (masked rows zeroed);
    background: (B, E); bratios: (B,).
    ebe passes l_z (B, S, E) normalized obs anomalies + x_l (B, E)
    normalized gridpoint anomalies: pair corr = localization o (z z^T)
    and the numerator row = rho o (x_l . z^T) (oi_ensi_multi.cpp:
    524-579); ebesc (629-860) uses the structure correlations directly.
    """
    s_cap = l_rho.shape[1]
    ft = {key: v.T for key, v in sel_fields.items()}  # (S, B)
    pi = {key: v[:, None, :] for key, v in ft.items()}
    pj = {key: v[None, :, :] for key, v in ft.items()}
    loc = structure.corr_jnp(pi, pj).astype(jnp.float32)  # (S, S, B)

    sv = sel_valid.T  # (S, B)
    in_m = jnp.moveaxis(l_innov, 0, 2)  # (S, E, B)
    if l_z is None:
        num = jnp.where(sv, l_rho.T, 0.0).astype(jnp.float32)
        pair = loc
    else:
        # Explicit multiply+reduce, not dot_general: default-precision
        # operand rounding (bf16 / TF32) breaks the symmetry of r_rr
        # feeding the solve (see ops/oi_ensi).
        z_m = jnp.moveaxis(l_z, 0, 2)  # (S, E, B)
        xl_m = x_l.T  # (E, B)
        num = jnp.where(sv, l_rho.T * (z_m * xl_m[None]).sum(axis=1),
                        0.0).astype(jnp.float32)
        pair = loc * (z_m[:, None] * z_m[None, :]).sum(axis=2)

    pair_valid = sv[:, None, :] & sv[None, :, :]
    eye = jnp.eye(s_cap, dtype=jnp.float32)[:, :, None]
    ridge = jnp.where(sv, l_r.T, 1.0)[:, None, :] * eye
    a_mat = jnp.where(pair_valid, pair, 0.0) + ridge
    a_mat = jnp.where(pair_valid | (eye > 0), a_mat, 0.0)
    lk = _gj_solve_batch_last(a_mat, num)  # (S, B)

    dx_m = bratios[None, :] * (lk[:, None, :] * in_m).sum(axis=0)  # (E, B)
    if not allow_extrapolation:
        # member-wise clamp (oi_ensi_multi.cpp:583-607), batch-last
        big = jnp.float32(np.inf)
        masked = jnp.where(sv[:, None, :], in_m, jnp.nan)
        max_inc = jnp.max(jnp.where(jnp.isnan(masked), -big, masked),
                          axis=0)  # (E, B)
        min_inc = jnp.min(jnp.where(jnp.isnan(masked), big, masked),
                          axis=0)
        c1 = (max_inc > 0) & (dx_m > max_inc)
        c2 = ~c1 & (max_inc < 0) & (dx_m > 0)
        c3 = ~c1 & ~c2 & (min_inc < 0) & (dx_m < min_inc)
        c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (dx_m < 0)
        dx_m = jnp.where(c1, max_inc,
                         jnp.where(c2, 0.0,
                                   jnp.where(c3, min_inc,
                                             jnp.where(c4, 0.0, dx_m))))
    ok = jnp.any(sv, axis=0) & jnp.all(jnp.isfinite(dx_m), axis=0)
    return jnp.where(ok[:, None], background + dx_m.T, background)


def make_ebe_kernel(structure, max_points: int, allow_extrapolation: bool):
    cache = structure.__dict__.setdefault("_ebe_kernel_cache", {})
    key = (int(max_points), bool(allow_extrapolation))
    if key in cache:
        return cache[key]

    @jax.jit
    def kernel(p1_fields, cand_fields, cand_valid, background, bratios,
               x_l, obs, pratios, innov, z_r):
        """background: (B, E); x_l: (B, E) normalized gridpoint anomalies;
        obs/pratios: (B, K); innov: (B, K, E); z_r: (B, K, E)."""
        k = pratios.shape[1]
        sel, sel_valid, l_rho = _select(structure, p1_fields, cand_fields,
                                        cand_valid, max_points, k)
        sel_fields = {key2: jnp.take_along_axis(cand_fields[key2], sel,
                                                axis=1)
                      for key2 in cand_fields}
        l_r = jnp.take_along_axis(pratios, sel, axis=1)
        l_z = jnp.take_along_axis(z_r, sel[:, :, None], axis=1)  # (B,S,E)
        l_innov = jnp.take_along_axis(innov, sel[:, :, None], axis=1)
        l_innov = jnp.where(sel_valid[:, :, None], l_innov, 0.0)
        return _member_update(structure, sel_fields, sel_valid, l_rho,
                              l_r, l_innov, background, bratios,
                              allow_extrapolation, l_z=l_z, x_l=x_l)

    cache[key] = kernel
    return kernel


def make_ebesc_kernel(structure, max_points: int, allow_extrapolation: bool):
    cache = structure.__dict__.setdefault("_ebesc_kernel_cache", {})
    key = (int(max_points), bool(allow_extrapolation))
    if key in cache:
        return cache[key]

    @jax.jit
    def kernel(p1_fields, cand_fields, cand_valid, background, bratios,
               obs, pratios, innov):
        k = pratios.shape[1]
        sel, sel_valid, l_rho = _select(structure, p1_fields, cand_fields,
                                        cand_valid, max_points, k)
        sel_fields = {key2: jnp.take_along_axis(cand_fields[key2], sel,
                                                axis=1)
                      for key2 in cand_fields}
        l_r = jnp.take_along_axis(pratios, sel, axis=1)
        l_innov = jnp.take_along_axis(innov, sel[:, :, None], axis=1)
        l_innov = jnp.where(sel_valid[:, :, None], l_innov, 0.0)
        return _member_update(structure, sel_fields, sel_valid, l_rho,
                              l_r, l_innov, background, bratios,
                              allow_extrapolation)

    cache[key] = kernel
    return kernel


def make_utem_kernel(structure, max_points: int, allow_extrapolation: bool):
    cache = structure.__dict__.setdefault("_utem_kernel_cache", {})
    key = (int(max_points), bool(allow_extrapolation))
    if key in cache:
        return cache[key]

    @jax.jit
    def kernel(p1_fields, cand_fields, cand_valid, background,
               background_corr, bratios, obs, pratios, y_anom, y_corr,
               y_hat):
        """background/background_corr: (B, E); obs/pratios: (B, K);
        y_anom/y_corr: (B, K, E); y_hat: (B, K)."""
        k = pratios.shape[1]
        sel, sel_valid, l_rho = _select(structure, p1_fields, cand_fields,
                                        cand_valid, max_points, k)
        l_obs = jnp.take_along_axis(obs, sel, axis=1)
        l_r = jnp.take_along_axis(pratios, sel, axis=1)
        l_yhat = jnp.take_along_axis(y_hat, sel, axis=1)
        l_y = jnp.take_along_axis(y_anom, sel[:, :, None], axis=1)
        l_yc = jnp.take_along_axis(y_corr, sel[:, :, None], axis=1)
        return _utem_core(sel_valid, l_rho, l_obs, l_r, l_yhat, l_y, l_yc,
                          background, background_corr, bratios,
                          allow_extrapolation)

    cache[key] = kernel
    return kernel


def _utem_core(sel_valid, l_rho, l_obs, l_r, l_yhat, l_y, l_yc,
               background, background_corr, bratios,
               allow_extrapolation: bool):
    """ETKF update tail (oi_ensi_multi.cpp:862-1311), shared by the host
    kernel and the serving sweep. All inputs are post-selection:
    sel_valid/l_rho/l_obs/l_r/l_yhat: (B, S); l_y/l_yc: (B, S, E);
    background/background_corr: (B, E); bratios: (B,)."""
    b, e = background.shape
    rinv = jnp.where(sel_valid, l_rho / l_r, 0.0)
    # batch-minor exact-f32 forms + symmetrize: default-precision
    # (bf16 / TF32) rounding makes a dot_general product asymmetric
    # and Newton-Schulz diverges on non-symmetric input
    # (see ops/oi_ensi._ensi_update)
    yc_m = jnp.moveaxis(l_yc, 0, 2)                    # (S, E, B)
    c_m = jnp.swapaxes(yc_m, 0, 1) \
        * jnp.moveaxis(rinv, 0, 1)[None]               # (E, S, B)
    pinv_m = _mm(c_m, yc_m)
    pinv_m = 0.5 * (pinv_m + jnp.swapaxes(pinv_m, 0, 1)) \
        + jnp.eye(e, dtype=jnp.float32)[:, :, None]
    # Coupled Newton-Schulz inverse sqrt (ops/oi_ensi._inv_sqrt_ns)
    # instead of batched eigh: gives W = sqrt((E-1) Pinv^{-1}) and
    # P C innov. Pinv here is SPD with lambda_min >= 1 by
    # construction, so the reference's `rcond <= 0` guard
    # (oi_ensi_multi.cpp:1106-1121: keep raw background + count a
    # warning) can only trigger on non-finite input; mirror it with
    # a finiteness check.
    z, c_norm = _inv_sqrt_ns_m(pinv_m)  # z: (E, E, B) batch-minor
    cond_ok = jnp.all(jnp.isfinite(pinv_m), axis=(0, 1)) \
        & jnp.all(jnp.isfinite(z), axis=(0, 1))
    innov = jnp.where(sel_valid, l_obs - l_yhat, 0.0)
    cv = (c_m * jnp.moveaxis(innov, 0, 1)[None]).sum(axis=1).T
    w_vec = _mv(z, _mv(z, cv)) / c_norm[:, None]

    ens_mean = jnp.mean(background, axis=1)
    x = background - ens_mean[:, None]
    ens_std = jnp.std(background, axis=1)  # population std
    mean_corr = jnp.mean(background_corr, axis=1)
    std_corr = jnp.std(background_corr, axis=1)
    const_fact = 1.0 / np.sqrt(max(e - 1, 1))
    x_corr = jnp.where(std_corr[:, None] <= DEFAULT_MIN_STD, 0.0,
                       const_fact * (background_corr
                                     - mean_corr[:, None])
                       / jnp.where(std_corr[:, None] == 0, 1,
                                   std_corr[:, None]))
    # increment_e = sum_k x_corr_k (ensStd W + bratios w 1^T)(k,e)
    # (oi_ensi_multi.cpp:1199-1204) with W = sqrt((E-1)/c) z
    # symmetric - computed as matvecs, W never materialized.
    increment = ens_std[:, None] \
        * jnp.sqrt((e - 1) / c_norm)[:, None] * _mv(z, x_corr) \
        + bratios[:, None] * jnp.sum(x_corr * w_vec, axis=1,
                                     keepdims=True)

    if not allow_extrapolation:
        # column-major lY[e] with the ACTUAL selection count as the row
        # stride (see ops/oi_ensi.py) - not the padded s_cap
        s = l_y.shape[1]
        cntv = jnp.maximum(jnp.sum(sel_valid, axis=1), 1)
        e_idx = jnp.arange(e)
        obs_i = e_idx[None, :] % cntv[:, None]
        mem_j = e_idx[None, :] // cntv[:, None]
        flat2 = jnp.reshape(l_y, (b, s * e))
        y_elem = jnp.take_along_axis(flat2, obs_i * e + mem_j, axis=1)
        diff = jnp.where(sel_valid[:, :, None],
                         (l_obs - l_yhat)[:, :, None]
                         - y_elem[:, None, :], jnp.nan)
        max_inc = jnp.max(jnp.where(jnp.isnan(diff), -jnp.inf, diff),
                          axis=1)
        min_inc = jnp.min(jnp.where(jnp.isnan(diff), jnp.inf, diff),
                          axis=1)
        member_inc = increment - x
        c1 = (max_inc > 0) & (member_inc > max_inc)
        c2 = ~c1 & (max_inc < 0) & (member_inc > 0)
        c3 = ~c1 & ~c2 & (min_inc < 0) & (member_inc < min_inc)
        c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (member_inc < 0)
        increment = jnp.where(
            c1, max_inc + x,
            jnp.where(c2, x, jnp.where(c3, min_inc + x,
                                       jnp.where(c4, x, increment))))

    analysis = ens_mean[:, None] + increment
    any_valid = jnp.any(sel_valid, axis=1)
    cond_bad = any_valid & ~cond_ok
    ok = any_valid & cond_ok & jnp.all(jnp.isfinite(analysis), axis=1)
    return jnp.where(ok[:, None], analysis, background), cond_bad


def make_member_serve_sweep(structure, field_keys, s_cap: int, block: int,
                            allow_extrapolation: bool, use_z: bool):
    """Whole-grid ebe/ebesc serving cycle from a cached shortlist.

    The geometric candidate tables (sel/rho/valid, from
    make_oi_select_sweep) are computed once per network; a cycle re-masks
    them with this cycle's obs validity, re-selects the top max_points,
    gathers ONE packed per-obs table row per selection (geometry fields +
    pratios + member innovations [+ normalized anomalies for ebe]) and
    runs the batch-last member update. tab columns:
    [field_keys..., pratios, innov(E) {, z(E) when use_z}] (+ zero pad).
    """
    key = (tuple(field_keys), int(s_cap), int(block),
           bool(allow_extrapolation), bool(use_z))
    cache, hit = _kernel_cache(structure, "_member_serve_cache", key)
    if hit is not None:
        return hit
    f = len(field_keys)

    @jax.jit
    def kernel(bg, bratios, x_l, tab, obs_ok, sel_c, rho_c, val_c):
        n, e = bg.shape
        nb, blk, k = sel_c.shape
        pad = nb * blk - n

        def pad_to(v, fill):
            if not pad:
                return v
            return jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:], fill, v.dtype)])

        bgp = pad_to(bg, jnp.nan).reshape(nb, blk, e)
        brp = pad_to(bratios, 0.0).reshape(nb, blk)
        if use_z:
            xlp = pad_to(x_l, 0.0).reshape(nb, blk, e)
        else:
            xlp = jnp.zeros((nb, 1, 1), jnp.float32)

        def body(args):
            selc, rhoc, valc, bgc, brc, xlc = args
            v = valc & jnp.take(obs_ok, selc, axis=0)
            vals, sub = jax.lax.top_k(jnp.where(v, rhoc, -jnp.inf), s_cap)
            sel_valid = jnp.isfinite(vals)
            l_rho = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
            g = jnp.take_along_axis(selc, sub, axis=1)
            ftab = jnp.take(tab, g, axis=0)  # (B, S, W)
            sel_fields = {key2: ftab[:, :, i]
                          for i, key2 in enumerate(field_keys)}
            l_r = ftab[:, :, f]
            l_innov = jnp.where(sel_valid[:, :, None],
                                ftab[:, :, f + 1:f + 1 + e], 0.0)
            if use_z:
                return _member_update(
                    structure, sel_fields, sel_valid, l_rho, l_r, l_innov,
                    bgc, brc, allow_extrapolation,
                    l_z=ftab[:, :, f + 1 + e:f + 1 + 2 * e], x_l=xlc)
            return _member_update(structure, sel_fields, sel_valid, l_rho,
                                  l_r, l_innov, bgc, brc,
                                  allow_extrapolation)

        out = jax.lax.map(body, (sel_c, rho_c, val_c, bgp, brp, xlp))
        return out.reshape(-1, e)[:n]

    cache[key] = kernel
    return kernel


def make_utem_serve_sweep(structure, s_cap: int, block: int,
                          allow_extrapolation: bool):
    """Whole-grid utem serving cycle from a cached shortlist.

    utem's update needs no pair-correlation geometry (Pinv comes from
    the y_corr ensemble anomalies), so the packed per-obs table is
    [obs, pratios, y_hat, y_anom(E), y_corr(E)] (+ zero pad).
    Returns (analysis (N, E), n_condition_failures).
    """
    key = (int(s_cap), int(block), bool(allow_extrapolation))
    cache, hit = _kernel_cache(structure, "_utem_serve_cache", key)
    if hit is not None:
        return hit

    @jax.jit
    def kernel(bg, bgc, bratios, tab, obs_ok, sel_c, rho_c, val_c):
        n, e = bg.shape
        nb, blk, k = sel_c.shape
        pad = nb * blk - n

        def pad_to(v, fill):
            if not pad:
                return v
            return jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:], fill, v.dtype)])

        bgp = pad_to(bg, jnp.nan).reshape(nb, blk, e)
        bgcp = pad_to(bgc, jnp.nan).reshape(nb, blk, e)
        brp = pad_to(bratios, 0.0).reshape(nb, blk)

        def body(args):
            selc, rhoc, valc, bg_b, bgc_b, br_b = args
            v = valc & jnp.take(obs_ok, selc, axis=0)
            vals, sub = jax.lax.top_k(jnp.where(v, rhoc, -jnp.inf), s_cap)
            sel_valid = jnp.isfinite(vals)
            l_rho = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
            g = jnp.take_along_axis(selc, sub, axis=1)
            ftab = jnp.take(tab, g, axis=0)  # (B, S, W)
            return _utem_core(sel_valid, l_rho, ftab[:, :, 0],
                              ftab[:, :, 1], ftab[:, :, 2],
                              ftab[:, :, 3:3 + e],
                              ftab[:, :, 3 + e:3 + 2 * e],
                              bg_b, bgc_b, br_b, allow_extrapolation)

        out, cond_bad = jax.lax.map(
            body, (sel_c, rho_c, val_c, bgp, bgcp, brp))
        return out.reshape(-1, e)[:n], jnp.sum(cond_bad.reshape(-1)[:n])

    cache[key] = kernel
    return kernel
