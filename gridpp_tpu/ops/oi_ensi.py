"""Ensemble OI (EnSI / local ensemble transform) device kernel.

Reference src/api/oi_ensi.cpp:114-568 runs a SERIAL loop over gridpoints
(OMP disabled due to a packaging segfault, oi_ensi.cpp:203-206), each doing
an E x E eigendecomposition. Here blocks of gridpoints run as one batched
XLA program in which the E x E algebra is vectorized over the gridpoint
batch, turning the reference's single-threaded bottleneck into dense
batched work.

Two modes:
- host-candidate kernel (make_ensi_kernel) for very large obs sets;
- dense whole-grid sweep (make_ensi_dense_sweep): rho against every
  observation on device, one dispatch for the full grid via lax.map.

Padding trick: invalid/padded observation slots get Rinv = 0 and zero
innovation, which leaves C = Y^T Rinv, Pinv, and w exactly as if the slot
were absent - no masking needed downstream.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_ensi_kernel", "make_ensi_dense_sweep"]

# Minimax-optimal odd-polynomial schedule for the coupled Newton-Schulz
# inverse-sqrt iteration (computed offline via per-step LP on the current
# singular-value interval, Polar-Express style). Applied as
# sigma <- a*sigma + b*sigma^3 + c*sigma^5, the composition maps every
# sigma in [2e-4, 1] to within 2e-5 of 1 (float32-verified); the two
# trailing (1.5, -0.5, 0) entries are plain Newton-Schulz steps whose
# quadratic convergence pushes the error to the float32 roundoff floor.
_NS_COEFFS = (
    (8.501080, -25.229504, 18.725874),
    (4.234522, -3.144556, 0.584696),
    (4.162825, -3.094790, 0.579020),
    (3.889070, -2.902615, 0.557114),
    (3.115613, -2.335580, 0.492763),
    (2.150920, -1.530978, 0.404032),
    (1.880115, -1.255672, 0.375568),
    (1.5, -0.5, 0.0),
    (1.5, -0.5, 0.0),
    (1.5, -0.5, 0.0),
)


def _mm(u, v):
    """Batched (E, E, B) matrix product: out[i,k,:] = sum_j u[i,j,:]v[j,k,:].

    Batch-minor layout: the contraction is E^3 fused vector FMAs over
    B-length vectors. It beat a batch-major einsum on a TPU; whether it
    still wins on the GPU is an open question (ROADMAP 1.3).

    The contraction is unrolled into a chain of adds: written as one
    multiply + reduce over the middle axis, XLA:GPU's compiler (jaxlib
    0.9.0) segfaults for some shapes, e.g. u (10, 8, B) x v (8, 10, B).
    """
    out = u[:, 0, None, :] * v[None, 0, :, :]
    for j in range(1, u.shape[1]):
        out = out + u[:, j, None, :] * v[None, j, :, :]
    return out


def _mv(z, x):
    """(E, E, B) matrix times per-batch vector (B, E) -> (B, E).

    Written as an explicit multiply + reduce, NOT an einsum: a
    dot_general at default precision may round its operands below f32
    (bf16 on a TPU, TF32 on a GPU), which the member increments cannot
    afford; this form is exact f32 on every backend."""
    return (z * jnp.swapaxes(x, 0, 1)[None, :, :]).sum(axis=1).T


def _inv_sqrt_ns(pinv):
    """Batched SPD inverse square root via coupled Newton-Schulz.

    pinv: (B, E, E) with lambda_min >= E-1 by construction
    (Pinv = Y^T Rinv Y + (E-1) I, oi_ensi.cpp:377-390). Returns
    (z, c) in BATCH-MINOR layout: z is (E, E, B) with
    pinv^{-1/2} = z / sqrt(c) and pinv^{-1} = z z / c.

    Replaces the batched `jnp.linalg.eigh` the round-2 kernel used,
    which was far slower on a TPU; this runs as ~36 small batched
    vector-FMA matmuls that fuse into the surrounding program (whether
    eigh wins on the GPU is ROADMAP 1.3). The
    coupled (Y, Z) form is used because the Z-only variant (T = Z A Z)
    is numerically unstable (Higham, Functions of Matrices, ch. 6);
    float32 accuracy matches an f32 eigh path (~kappa * eps relative
    error).
    """
    return _inv_sqrt_ns_m(jnp.moveaxis(pinv, 0, 2))


def _inv_sqrt_ns_m(pinv_m):
    """_inv_sqrt_ns with the input already batch-minor: (E, E, B)."""
    e = pinv_m.shape[0]
    dt = pinv_m.dtype
    # inf-norm upper bound on lambda_max for normalization
    c = jnp.max(jnp.sum(jnp.abs(pinv_m), axis=1), axis=0)
    c = jnp.where(jnp.isfinite(c) & (c > 0), c, 1.0)
    a_mat = pinv_m / c  # (E, E, B)
    # the iteration diverges on non-symmetric input; enforce symmetry
    a_mat = 0.5 * (a_mat + jnp.swapaxes(a_mat, 0, 1))
    eye = jnp.eye(e, dtype=dt)[:, :, None]
    y = a_mat
    z = jnp.broadcast_to(eye, a_mat.shape)
    last = len(_NS_COEFFS) - 1
    for i, (ca, cb, cc) in enumerate(_NS_COEFFS):
        if i == 0:
            t = a_mat  # z = I, y = A
        else:
            t = _mm(z, y)
            t = 0.5 * (t + jnp.swapaxes(t, 0, 1))
        q = ca * eye + cb * t
        if cc:
            q = q + cc * _mm(t, t)
        if i != last:  # y is not needed after the final z update
            y = _mm(y, q)
        z = _mm(q, z)
    z = 0.5 * (z + jnp.swapaxes(z, 0, 1))
    return z, c


def _ensi_update(structure, sel_valid, l_rho, l_obs, l_sig, l_y, l_yhat,
                 background, allow_extrapolation: bool):
    """Shared EnSI tail after selection (oi_ensi.cpp:296-553).

    l_y: (B, S, E) anomalies; background: (B, E) valid members.
    """
    b, e = background.shape

    # Rinv diagonal: rho / sigma^2 (oi_ensi.cpp:296-302); zero for padded
    rinv = jnp.where(sel_valid, l_rho / (l_sig * l_sig), 0.0)

    # Batch-minor panels: (S, E, B) anomalies, (E, S, B) weighted rows.
    # Everything from here runs as exact-f32 multiply+reduce with the
    # batch on the minor axis - NOT einsums: a dot_general at default
    # precision may round its operands below f32 (bf16 on a TPU, TF32
    # on a GPU), which makes the Pinv product ASYMMETRIC (pinv[i,j] and
    # pinv[j,i] round differently), and Newton-Schulz diverges on
    # non-symmetric input (observed on a TPU: ~0.01% of gridpoints
    # blowing up to ~1e23 while the same matrices converge fine in
    # f32).
    y_m = jnp.moveaxis(l_y, 0, 2)            # (S, E, B)
    c_m = jnp.swapaxes(y_m, 0, 1) * jnp.moveaxis(rinv, 0, 1)[None]
    pinv_m = _mm(c_m, y_m)                   # (E, E, B)
    pinv_m = 0.5 * (pinv_m + jnp.swapaxes(pinv_m, 0, 1)) \
        + (e - 1) * jnp.eye(e, dtype=jnp.float32)[:, :, None]

    # W = sqrt((E-1) Pinv^{-1}) and P C innov via the coupled
    # Newton-Schulz inverse sqrt (see _inv_sqrt_ns) instead of the
    # reference's rcond + inv + eig_sym sequence (oi_ensi.cpp:386-421).
    # Pinv is SPD by construction (lambda_min >= E-1), so the reference's
    # `rcond <= 0` fallback (oi_ensi.cpp:386-390) can only trigger on
    # non-finite input; mirror it with a finiteness guard, counted the
    # same way (oi_ensi.cpp:557-566).
    z, c_norm = _inv_sqrt_ns_m(pinv_m)  # z: (E, E, B) batch-minor
    cond_ok = jnp.all(jnp.isfinite(pinv_m), axis=(0, 1)) \
        & jnp.all(jnp.isfinite(z), axis=(0, 1))

    innov = jnp.where(sel_valid, l_obs - l_yhat, 0.0)
    # w = P C innov with P = Pinv^{-1} = z z / c: two (E x E) matvecs
    cv = (c_m * jnp.moveaxis(innov, 0, 1)[None]).sum(axis=1).T
    w_vec = _mv(z, _mv(z, cv)) / c_norm[:, None]

    # increment_e = sum_k x_k (W + w 1^T)(k,e) = (W x)_e + (x . w),
    # with W = sqrt((E-1)/c) z symmetric - the full (B, E, E) W of the
    # reference (oi_ensi.cpp:429-444) is never materialized.
    ens_mean = jnp.mean(background, axis=1)
    x = background - ens_mean[:, None]
    increment = jnp.sqrt((e - 1) / c_norm)[:, None] * _mv(z, x) \
        + jnp.sum(x * w_vec, axis=1, keepdims=True)

    if not allow_extrapolation:
        # Reference quirk (oi_ensi.cpp:520-537): lY[e] is the e-th element
        # of the column-major flattened Y matrix - with the ACTUAL
        # per-gridpoint selection count as the row stride, so the member
        # index decomposes as (obs e % cnt, member e // cnt). A fixed
        # s_cap stride would read garbage-gathered padded slots whenever
        # fewer than max_points obs are in range (matches the native
        # solver and the reference; found in round-4 self-review).
        s = l_y.shape[1]
        cntv = jnp.maximum(jnp.sum(sel_valid, axis=1), 1)  # (B,)
        e_idx = jnp.arange(e)
        obs_i = e_idx[None, :] % cntv[:, None]       # (B, E)
        mem_j = e_idx[None, :] // cntv[:, None]      # (B, E), < E
        flat2 = jnp.reshape(l_y, (b, s * e))         # row-major (S, E)
        y_elem = jnp.take_along_axis(flat2, obs_i * e + mem_j, axis=1)
        diff = jnp.where(sel_valid[:, :, None],
                         (l_obs - l_yhat)[:, :, None]
                         - y_elem[:, None, :], jnp.nan)
        max_inc = jnp.max(jnp.where(jnp.isnan(diff), -jnp.inf, diff), axis=1)
        min_inc = jnp.min(jnp.where(jnp.isnan(diff), jnp.inf, diff), axis=1)
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


def make_ensi_kernel(structure, max_points: int, allow_extrapolation: bool):
    cache = structure.__dict__.setdefault("_ensi_kernel_cache", {})
    key = (int(max_points), bool(allow_extrapolation))
    if key in cache:
        return cache[key]

    @jax.jit
    def kernel(p1_fields, cand_fields, cand_valid, background,
               obs, sigmas, y_anom, y_hat):
        """background: (B, E) valid members; obs/sigmas: (B, K) gathered;
        y_anom: (B, K, E) anomalies at obs points; y_hat: (B, K)."""
        k = obs.shape[1]
        s_cap = min(max_points, k) if max_points > 0 else k
        rho = structure.corr_background_jnp(p1_fields, cand_fields)
        valid = cand_valid & (rho > 0)
        vals, sel = jax.lax.top_k(jnp.where(valid, rho, -jnp.inf), s_cap)
        sel_valid = jnp.isfinite(vals)
        l_rho = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
        l_obs = jnp.take_along_axis(obs, sel, axis=1)
        l_sig = jnp.take_along_axis(sigmas, sel, axis=1)
        l_yhat = jnp.take_along_axis(y_hat, sel, axis=1)
        l_y = jnp.take_along_axis(y_anom, sel[:, :, None], axis=1)
        return _ensi_update(structure, sel_valid, l_rho, l_obs, l_sig, l_y,
                            l_yhat, background, allow_extrapolation)

    cache[key] = kernel
    return kernel


def make_ensi_shortlist_sweep(structure, max_points: int,
                              allow_extrapolation: bool, block: int):
    """Whole-grid EnSI from a canonical candidate shortlist (ONE
    dispatch). Selection order/rho come from the host-computed canonical
    shortlist (ops/canonical.py) so the API's per-call top-k decision is
    bit-identical to the serving pipelines' and the native host
    solver's. Per call: mask candidates with invalid obs, re-select the
    top max_points among survivors, run the local ensemble transform.
    The caller is responsible for the starved-row fallback (rows whose
    truncated shortlist keeps fewer than max_points valid candidates)."""
    cache = structure.__dict__.setdefault("_ensi_shortlist_sweep_cache", {})
    key = (int(max_points), bool(allow_extrapolation), int(block))
    if key in cache:
        return cache[key]

    @jax.jit
    def kernel(sel, rho, valid, background, obs, sigmas, y_anom, y_hat):
        """sel/rho/valid: (N, K) canonical shortlist; background: (N, E);
        obs/sigmas/y_hat: (P,); y_anom: (P, E)."""
        n, k_cap = sel.shape
        e = background.shape[1]
        s_cap = min(max_points, k_cap) if max_points > 0 else k_cap
        obs_ok = jnp.isfinite(obs)
        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v, fill):
            if not pad:
                return v
            return jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:], fill, v.dtype)])

        args = (pad_to(sel, 0).reshape(nb, block, k_cap),
                pad_to(rho, 0.0).reshape(nb, block, k_cap),
                pad_to(valid, False).reshape(nb, block, k_cap),
                pad_to(background, jnp.nan).reshape(nb, block, e))

        def body(chunk):
            selc, rhoc, valc, bgc = chunk
            v = valc & jnp.take(obs_ok, selc, axis=0)
            vals, sub = jax.lax.top_k(jnp.where(v, rhoc, -jnp.inf), s_cap)
            sel_valid = jnp.isfinite(vals)
            l_rho = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
            g = jnp.take_along_axis(selc, sub, axis=1)
            l_obs = jnp.take(obs, g, axis=0)
            l_sig = jnp.take(sigmas, g, axis=0)
            l_yhat = jnp.take(y_hat, g, axis=0)
            l_y = jnp.take(y_anom, g, axis=0)  # (B, S, E)
            return _ensi_update(structure, sel_valid, l_rho, l_obs, l_sig,
                                l_y, l_yhat, bgc, allow_extrapolation)

        out, cond_bad = jax.lax.map(body, args)
        return out.reshape(-1, e)[:n], cond_bad.reshape(-1)[:n]

    cache[key] = kernel
    return kernel


def make_ensi_dense_sweep(structure, max_points: int,
                          allow_extrapolation: bool, block: int):
    """Whole-grid EnSI in one dispatch: rho against every observation,
    top-k selection on device, lax.map over gridpoint chunks."""
    cache = structure.__dict__.setdefault("_ensi_dense_sweep_cache", {})
    key = (int(max_points), bool(allow_extrapolation), int(block))
    if key in cache:
        return cache[key]

    @jax.jit
    def kernel(p1_fields, obs_fields, background, obs, sigmas, y_anom,
               y_hat):
        """p1_fields: dict of (N,); obs_fields: dict of (P,);
        background: (N, E); obs/sigmas/y_hat: (P,); y_anom: (P, E)."""
        n, e = background.shape
        p = obs.shape[0]
        s_cap = min(max_points, p) if max_points > 0 else p
        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v, fill=jnp.nan):
            if not pad:
                return v
            shape = (pad,) + v.shape[1:]
            return jnp.concatenate([v, jnp.full(shape, fill, v.dtype)])

        p1s = {k2: pad_to(v).reshape(nb, block, 1)
               for k2, v in p1_fields.items()}
        bg = pad_to(background).reshape(nb, block, e)
        o2 = {k2: v[None, :] for k2, v in obs_fields.items()}

        def body(args):
            p1c, bgc = args
            rho = structure.corr_background_jnp(p1c, o2)  # (B, P)
            valid = rho > 0
            vals, sel = jax.lax.top_k(jnp.where(valid, rho, -jnp.inf),
                                      s_cap)
            sel_valid = jnp.isfinite(vals)
            l_rho = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
            l_obs = jnp.take(obs, sel, axis=0)
            l_sig = jnp.take(sigmas, sel, axis=0)
            l_yhat = jnp.take(y_hat, sel, axis=0)
            l_y = jnp.take(y_anom, sel, axis=0)  # (B, S, E)
            return _ensi_update(structure, sel_valid, l_rho, l_obs, l_sig,
                                l_y, l_yhat, bgc, allow_extrapolation)

        out, cond_bad = jax.lax.map(body, (p1s, bg))
        return out.reshape(-1, e)[:n], cond_bad.reshape(-1)[:n]

    cache[key] = kernel
    return kernel
