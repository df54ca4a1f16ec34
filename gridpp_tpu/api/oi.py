"""Optimal interpolation API (reference src/api/oi.cpp).

Host orchestration: validate, flatten, pre-filter invalid observations,
run the variable-radius candidate query once, then stream blocks of
gridpoints through the batched device kernel (ops/oi.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import MV
from ..core.grid import Grid
from ..core.points import Points
from ..ops.oi import (make_oi_dense_sweep, make_oi_gather_kernel,
                      make_oi_shortlist_sweep)
from ._common import asarray_f32, on_host

__all__ = ["optimal_interpolation", "optimal_interpolation_full"]

# Gridpoints per device block: bounds peak memory for the (B, S, S)
# covariance assembly.
_BLOCK = 524288


def _point_fields(xyz, elevs, lafs, idx=None):
    if idx is None:
        return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                "elev": elevs.astype(np.float64),
                "laf": lafs.astype(np.float64)}
    return {"x": xyz[idx, 0], "y": xyz[idx, 1], "z": xyz[idx, 2],
            "elev": elevs[idx].astype(np.float64),
            "laf": lafs[idx].astype(np.float64)}


_BALL_QUERY_MAX = 262_144


def _candidates(bpoints: Points, opts: Points, loc, max_points):
    """Padded in-radius candidate lists (cand, mask) or None when empty.

    Small problems use the exact ball query. Large grids use
    k-nearest-within-radius, which returns dense numpy arrays straight
    from the tree (the ball query would materialize millions of Python
    lists) - and k is GROWN until every gridpoint's k-th neighbour lies
    beyond its localization radius, so the shortlist provably contains
    every in-radius observation. This keeps top-rho selection exact even
    when elev/laf kernels make rho non-monotone in distance
    (reference semantics: oi.cpp:233-281).
    """
    n = bpoints.size()
    loc = np.asarray(loc, np.float64)
    n_obs = opts.size()
    # Cache on the background points: obs networks and localization scales
    # are static across forecast cycles, so the padded candidate arrays are
    # reused while only obs *values* change.
    cache = bpoints.__dict__.setdefault("_cand_cache", {})
    key = (n_obs, hash(opts.lats.tobytes()), hash(opts.lons.tobytes()),
           float(loc.min()) if loc.size else 0.0,
           float(loc.max()) if loc.size else 0.0,
           float(loc.sum()) if loc.size else 0.0, int(max_points))
    if key in cache:
        return cache[key]
    obs_tree = opts.index.tree
    bxyz = bpoints.xyz
    if n <= _BALL_QUERY_MAX:
        if loc.size and np.all(loc == loc.ravel()[0]):
            lists = obs_tree.query_ball_point(bxyz, r=float(loc.ravel()[0]),
                                              workers=-1)
        else:
            lists = obs_tree.query_ball_point(bxyz, r=loc, workers=-1)
        counts = np.fromiter((len(l) for l in lists), dtype=np.int64,
                             count=len(lists))
        kmax = int(counts.max()) if counts.size else 0
        if kmax == 0:
            return None
        cand = np.zeros((n, kmax), dtype=np.int32)
        mask = np.zeros((n, kmax), dtype=bool)
        for i, lst in enumerate(lists):
            c = len(lst)
            if c:
                cand[i, :c] = lst
                mask[i, :c] = True
    else:
        k_cand = min(n_obs, max(4 * max_points, 32) if max_points > 0
                     else n_obs)
        rmax = float(loc.max()) if loc.size else 0.0
        dist, cand = obs_tree.query(bxyz, k=k_cand,
                                    distance_upper_bound=rmax, workers=-1)
        if k_cand == 1:
            dist = dist[:, None]
            cand = cand[:, None]
        # Exactness: a row's shortlist is complete once its k-th neighbour
        # distance exceeds its localization radius (an infinite k-th
        # distance means fewer than k obs exist within rmax). Re-query the
        # incomplete rows with a larger k until all rows are complete.
        if k_cand < n_obs:
            locv = loc if loc.ndim else np.full(n, float(loc))
            incomplete = np.nonzero(dist[:, -1] <= locv)[0]
            while incomplete.size and k_cand < n_obs:
                k_new = min(4 * k_cand, n_obs)
                d2, c2 = obs_tree.query(bxyz[incomplete], k=k_new,
                                        distance_upper_bound=rmax,
                                        workers=-1)
                grow = k_new - k_cand
                dist = np.pad(dist, ((0, 0), (0, grow)),
                              constant_values=np.inf)
                cand = np.pad(cand, ((0, 0), (0, grow)),
                              constant_values=n_obs)
                dist[incomplete] = d2
                cand[incomplete] = c2
                k_cand = k_new
                if k_cand >= n_obs:
                    break
                incomplete = incomplete[d2[:, -1] <= locv[incomplete]]
        mask = dist <= loc[:, None]
        cand = np.where(mask, cand, 0).astype(np.int32)
        if not mask.any():
            return None
    if len(cache) > 8:
        cache.clear()
    cache[key] = (cand, mask)
    return cand, mask


def _candidates_block(bpoints: Points, opts: Points, loc, start, end,
                      obs_key):
    """Exact ball-query candidates for one gridpoint block [start, end).

    Used by the host path on large grids: the global padded array would
    need kmax columns for ALL gridpoints (10+ GB at 2000^2 with a dense
    network), while per-block arrays stay bounded and cache per block.
    kmax is rounded up to a power of two so at most a handful of kernel
    shapes ever compile.
    """
    cache = bpoints.__dict__.setdefault("_cand_block_cache", {})
    key = (obs_key, int(start), int(end))
    if key in cache:
        return cache[key]
    bxyz = bpoints.xyz[start:end]
    locb = loc[start:end]
    obs_tree = opts.index.tree
    if locb.size and np.all(locb == locb.ravel()[0]):
        lists = obs_tree.query_ball_point(bxyz, r=float(locb.ravel()[0]),
                                          workers=-1)
    else:
        lists = obs_tree.query_ball_point(bxyz, r=locb, workers=-1)
    counts = np.fromiter((len(l) for l in lists), dtype=np.int64,
                         count=len(lists))
    kmax = int(counts.max()) if counts.size else 0
    if kmax == 0:
        cache[key] = None
        return None
    kpad = 8
    while kpad < kmax:
        kpad *= 2
    nb = end - start
    cand = np.zeros((nb, kpad), dtype=np.int32)
    mask = np.zeros((nb, kpad), dtype=bool)
    for i, lst in enumerate(lists):
        c = len(lst)
        if c:
            cand[i, :c] = lst
            mask[i, :c] = True
    if len(cache) > 64:
        cache.clear()
    cache[key] = (cand, mask)
    return cand, mask


def _resolved_fields(pts: Points, structure, origin=None) -> dict:
    """Point fields with structure length scales resolved (host).

    When `origin` (an ECEF centroid) is given, coordinates are shifted to
    it and cast to float32: translation leaves all chord distances
    unchanged while restoring full f32 precision near the domain (absolute
    ECEF values ~6.4e6 m would quantize to ~0.5 m steps in f32).
    """
    fields = _point_fields(pts.xyz, pts.elevs, pts.lafs)
    fields["lat"] = pts.lats.astype(np.float64)
    fields["lon"] = pts.lons.astype(np.float64)
    fields = structure.resolve_p1_np(fields)
    fields.pop("lat", None)
    fields.pop("lon", None)
    if origin is not None:
        for i, key in enumerate(("x", "y", "z")):
            fields[key] = (fields[key] - origin[i]).astype(np.float32)
        for key in fields:
            fields[key] = np.asarray(fields[key], np.float32)
    return fields


def _with_scales(fields, structure, count):
    """Field dict + per-point h/v/w arrays (scalar structures broadcast
    their scale attributes) for the native solvers."""
    out = dict(fields)
    for key in ("h", "v", "w"):
        if key not in out:
            out[key] = np.full(count, float(getattr(structure, key, 0.0)),
                               np.float32)
    return out


def _native_kernel_type(structure):
    """Native rho-kernel id for structures the C++ OI solver supports.

    Exact-type match: subclasses may override _corr, and
    Multiple/CrossValidation/Linear have non-product or value-based
    correlation semantics the native kernel does not implement.
    """
    from ..structure import (BarnesStructure, CressmanStructure,
                             PowerlawStructure, SoarStructure,
                             ToarStructure)
    return {BarnesStructure: 0, CressmanStructure: 1, SoarStructure: 2,
            ToarStructure: 3, PowerlawStructure: 4}.get(type(structure))


def _chunked_shortlist(bpoints, opts, structure, loc, max_points, n):
    """Canonical shortlist feed for the chunked native host paths
    (OI and EnSI), or None when the per-block ball queries are the
    better precompute.

    `opts` holds only valid observations (the callers pre-filter,
    oi.cpp:250-260), so the canonical top-k_cap by rho
    (ops/canonical.py; the same native pair evaluator the solvers'
    in-kernel select_topk runs) provably contains the exact top
    max_points for every gridpoint — feeding the solvers from it is
    bit-identical to the exact ball queries (verified at 700^2 with an
    active elevation kernel). It wins when the shortlist is cheap
    (monotone rho order: obs elev/laf uniform, so the k-NN proposal is
    complete with no growth — the 2000^2/10k cold call drops ~7 min ->
    ~1 min and the solver scans 4*max_points candidates instead of the
    ~in-radius count, 20.5 s -> ~6 s warm) or when the network is
    dense (the ball path materializes millions of scipy Python lists
    whose cost grows with the in-radius count). Sparse networks with
    active vertical/laf kernels (where the rho bound cannot prune)
    keep the ball path. max_points <= 0 means "use every in-radius
    obs", which a capped shortlist cannot serve.
    """
    if int(max_points) <= 0:
        return None
    from ..ops.canonical import canonical_shortlist, monotone_obs
    use_sl = monotone_obs(structure, opts)
    if not use_sl:
        # sampled mean in-radius count; the crossover sits between
        # ~100 (ball faster) and ~360 (shortlist faster) on this
        # class of machine
        step = max(1, n // 2048)
        cts = opts.index.radius_counts(
            bpoints.lats[::step], bpoints.lons[::step],
            float(np.max(loc)) if np.asarray(loc).size else 0.0)
        use_sl = cts.size > 0 and float(cts.mean()) >= 192.0
    if not use_sl:
        return None
    k_cap = min(opts.size(), max(4 * int(max_points), 32))
    return canonical_shortlist(bpoints, opts, structure, k_cap)


def _oi_native(bpoints, opts, loc, structure, kt, p1_np, o_np, pobs_k,
               pbg_k, pratios_k, background, bvariance, max_points,
               allow_extrapolation, chunked, cand, mask, obs_key):
    """Run the threaded native per-gridpoint OI solve (csrc
    oi_host_solve); returns (analysis, avariance) or None when the
    native engine is unavailable."""
    from .. import native
    if native.get_lib() is None:
        return None
    n = bpoints.size()

    gfx = _with_scales(p1_np, structure, n)
    gfx["loc"] = np.asarray(loc, np.float32)
    ofx = _with_scales(o_np, structure, opts.size())
    ofx["loc"] = np.asarray(
        structure.localization_np(opts.lats, opts.lons), np.float32)

    if not chunked:
        res = native.oi_host_solve(
            gfx, ofx, pobs_k, pbg_k, pratios_k, cand, mask, kt,
            int(max_points), bool(allow_extrapolation), background,
            bvariance)
        return res

    sl = _chunked_shortlist(bpoints, opts, structure, loc, max_points, n)

    out = np.asarray(background, np.float32).copy()
    avar = np.asarray(bvariance, np.float32).copy()
    block = _BLOCK
    for start in range(0, n, block):
        end = min(start + block, n)
        if sl is not None:
            res_b = (sl.sel[start:end], sl.valid[start:end])
        else:
            res_b = _candidates_block(bpoints, opts, loc, start, end,
                                      obs_key)
            if res_b is None:
                continue
        gfb = {k: v[start:end] for k, v in gfx.items()}
        res = native.oi_host_solve(
            gfb, ofx, pobs_k, pbg_k, pratios_k, res_b[0], res_b[1], kt,
            int(max_points), bool(allow_extrapolation),
            background[start:end], bvariance[start:end])
        if res is None:
            return None
        out[start:end] = res[0]
        avar[start:end] = res[1]
    return out, avar


def _oi_points(bpoints: Points, background, bvariance, points: Points,
               pobs, obs_variance, pbackground, bvariance_at_points,
               structure, max_points, allow_extrapolation):
    """Points-form optimal_interpolation_full (oi.cpp:138-341)."""
    n = bpoints.size()
    ns = points.size()
    background = np.asarray(background, np.float32)
    bvariance = np.asarray(bvariance, np.float32)
    output = background.copy()
    avar = bvariance.copy()
    if ns == 0:
        return output, avar

    pratios = np.asarray(obs_variance, np.float32) / np.asarray(
        bvariance_at_points, np.float32)
    pobs = np.asarray(pobs, np.float32)
    pbackground = np.asarray(pbackground, np.float32)

    # Pre-filter observations with invalid values (oi.cpp:250-260): they can
    # never be selected, so drop them from the candidate pool entirely.
    keep = np.isfinite(pobs) & np.isfinite(pbackground)
    if not keep.any():
        return output, avar
    kidx = np.nonzero(keep)[0]
    opts = points.subset(kidx)
    pobs_k = pobs[kidx]
    pbg_k = pbackground[kidx]
    pratios_k = pratios[kidx]

    # Canonical-shortlist device path (accelerator-only): selection
    # order/rho come from the cached host-computed canonical shortlist
    # (ops/canonical.py), making the API's per-call selection
    # BIT-IDENTICAL to the serving pipelines' and the native host
    # solvers'. Falls back to the full-depth paths below when any
    # truncated gridpoint keeps fewer than max_points valid candidates
    # this cycle (the reference digs deeper, oi.cpp:250-281).
    if not on_host() and max_points > 0 and points.size() > 0:
        res_sl = _oi_points_shortlist(
            bpoints, background, bvariance, points, pobs, pratios,
            pbackground, structure, max_points, allow_extrapolation)
        if res_sl is not None:
            return res_sl

    # Dense device path: with a moderate observation count, evaluate rho
    # against every observation on device (no host spatial query, no
    # candidate arrays over the host-device link). Every structure zeroes
    # rho beyond its localization distance, so rho>0 == the radius query.
    # On the host (the pinned numpy API) the cached cKDTree shortlist is
    # far cheaper than an all-pairs rho sweep, so the dense path is
    # accelerator-only.
    if (not on_host() and 0 < opts.size() <= 32768
            and n * opts.size() > 4_000_000):
        return _oi_points_dense(bpoints, background, bvariance, opts,
                                pobs_k, pratios_k, pbg_k, structure,
                                max_points, allow_extrapolation, output,
                                avar)

    # Localization radii (may vary per gridpoint for spatial structures)
    blats = bpoints.lats
    blons = bpoints.lons
    loc = structure.localization_np(blats, blons)

    # On large host grids, candidates are queried (and cached) per block:
    # a single global padded array needs max-in-radius columns for every
    # gridpoint, which is GBs at 2000^2 with a dense network.
    chunked = on_host() and n > _BALL_QUERY_MAX
    cand_dev = mask_dev = None
    if not chunked:
        res = _candidates(bpoints, opts, loc, max_points)
        if res is None:
            return output, avar
        cand, mask = res
        if not on_host():
            cand_dev = jnp.asarray(cand)
            mask_dev = jnp.asarray(mask)
    obs_key = (opts.size(), hash(opts.lats.tobytes()),
               hash(opts.lons.tobytes()),
               float(loc.min()) if loc.size else 0.0,
               float(loc.max()) if loc.size else 0.0)
    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin)
    o_fields = _device_fields(opts, structure, origin)
    host = on_host()
    if host:
        # numpy block slices are views (no per-slice XLA dispatch); the
        # per-block gathers live inside the jitted kernel
        # (make_oi_gather_kernel)
        p1_all = {k: np.asarray(v) for k, v in p1_all.items()}
        # Threaded native solver for the product-kernel structures: the
        # XLA:CPU fused program runs this path effectively
        # single-threaded (~40 s at 2000^2/10k; the native kernel is
        # ~8x with identical f32 semantics). Exotic structures
        # (Multiple/CrossValidation/Linear) keep the XLA path.
        kt = _native_kernel_type(structure)
        if kt is not None:
            res_nat = _oi_native(
                bpoints, opts, loc, structure, kt, p1_all,
                {k: np.asarray(v) for k, v in o_fields.items()},
                pobs_k, pbg_k, pratios_k, background, bvariance,
                max_points, allow_extrapolation, chunked,
                None if chunked else cand, None if chunked else mask,
                obs_key)
            if res_nat is not None:
                return res_nat
    j_obs = jnp.asarray(pobs_k)
    j_bg = jnp.asarray(pbg_k)
    j_ratios = jnp.asarray(pratios_k)

    kernel = make_oi_gather_kernel(structure, int(max_points),
                                   bool(allow_extrapolation))
    bg_flat = background if host else jnp.asarray(background)
    bvar_flat = bvariance if host else jnp.asarray(bvariance)

    # Keep all block outputs on device; one transfer at the end.
    outs = []
    avars = []
    block = _BLOCK
    for start in range(0, n, block):
        end = min(start + block, n)
        if chunked:
            res_b = _candidates_block(bpoints, opts, loc, start, end,
                                      obs_key)
            if res_b is None:  # no obs in radius for this whole block
                outs.append(bg_flat[start:end])
                avars.append(bvar_flat[start:end])
                continue
            cand_b, mask_b = res_b
        elif host:
            cand_b, mask_b = cand[start:end], mask[start:end]
        else:
            cand_b, mask_b = cand_dev[start:end], mask_dev[start:end]
        p1 = {k: v[start:end][:, None] for k, v in p1_all.items()}
        out_b, avar_b = kernel(p1, o_fields, cand_b, mask_b,
                               bg_flat[start:end], bvar_flat[start:end],
                               j_obs, j_bg, j_ratios)
        outs.append(out_b)
        avars.append(avar_b)
    if len(outs) == 1:
        return np.asarray(outs[0]), np.asarray(avars[0])
    if host:
        # XLA:CPU outputs: host concatenate (no link to cross)
        output = np.concatenate([np.asarray(o) for o in outs])
        avar = np.concatenate([np.asarray(a) for a in avars])
    else:
        # keep blocks on device; ONE transfer at the end
        output = np.asarray(jnp.concatenate(
            [jnp.asarray(o) for o in outs]))
        avar = np.asarray(jnp.concatenate(
            [jnp.asarray(a) for a in avars]))
    return output, avar


def _origin(bpoints):
    cached = bpoints.__dict__.get("_origin_cache")
    if cached is None:
        cached = bpoints.xyz.mean(axis=0)
        bpoints.__dict__["_origin_cache"] = cached
    return cached


def _device_fields(pts: Points, structure, origin) -> dict:
    """Device-resident resolved point fields, cached on the points object.

    Grid coordinates are static across forecast cycles; keeping them on
    device avoids re-uploading ~100 MB of fields per OI call.
    """
    cache = pts.__dict__.setdefault("_dev_field_cache", {})
    spatial_id = id(structure) if getattr(structure, "is_spatial", False) \
        else None
    key = (spatial_id, tuple(np.round(origin, 3)))
    if key not in cache:
        fields = _resolved_fields(pts, structure, origin)
        if len(cache) > 4:
            cache.clear()
        cache[key] = {k: jnp.asarray(v) for k, v in fields.items()}
    return cache[key]


def _oi_points_dense(bpoints, background, bvariance, opts, pobs_k,
                     pratios_k, pbg_k, structure, max_points,
                     allow_extrapolation, output, avar):
    """Fully on-device OI: only obs values and per-block field slices (all
    device-resident) are touched per call."""
    n = bpoints.size()
    p = opts.size()
    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin)
    o_fields = _device_fields(opts, structure, origin)
    j_obs = jnp.asarray(pobs_k)
    j_bg = jnp.asarray(pbg_k)
    j_ratios = jnp.asarray(pratios_k)
    bg_j = jnp.asarray(background)
    bvar_j = jnp.asarray(bvariance)
    # Chunk size capped so the per-chunk (B, P) rho matrix stays ~<1 GB;
    # the whole sweep runs as one dispatch (lax.map inside jit)
    block = max(8192, min(_BLOCK, (1 << 28) // max(p, 1)))
    kernel = make_oi_dense_sweep(structure, int(max_points),
                                 bool(allow_extrapolation), block)
    p1 = {k: v for k, v in p1_all.items()}
    out_j, avar_j = kernel(p1, o_fields, bg_j, bvar_j, j_obs, j_bg,
                           j_ratios)
    return np.asarray(out_j), np.asarray(avar_j)


def _shortlist_dev(bpoints, points, structure, k_cap):
    """Canonical shortlist + device-resident copies, cached on bpoints.

    Returns (sel, rho, valid, truncated device arrays, CanonicalShortlist).
    """
    from ..ops.canonical import canonical_shortlist
    sl = canonical_shortlist(bpoints, points, structure, k_cap)
    cache = bpoints.__dict__.setdefault("_canon_dev_cache", {})
    key = id(sl)
    dev = cache.get(key)
    if dev is None:
        if len(cache) > 4:
            cache.clear()
        dev = (jnp.asarray(sl.sel), jnp.asarray(sl.rho),
               jnp.asarray(sl.valid), jnp.asarray(sl.truncated), sl)
        cache[key] = dev
    return dev


def _shortlist_dev_padded(bpoints, points, structure, k_cap, block):
    """Shortlist device arrays pre-padded/blocked to (nb, block, K) — the
    layout the ensi/ensi_multi serve sweeps consume. Cached on bpoints."""
    from ..ops.canonical import canonical_shortlist
    sl = canonical_shortlist(bpoints, points, structure, k_cap)
    cache = bpoints.__dict__.setdefault("_canon_dev_pad_cache", {})
    key = (id(sl), int(block))
    hit = cache.get(key)
    if hit is not None:
        return hit
    n, k = sl.sel.shape
    nb = -(-n // block)
    pad = nb * block - n

    def pad_to(v, fill):
        if not pad:
            return v
        return np.concatenate(
            [v, np.full((pad,) + v.shape[1:], fill, v.dtype)])

    dev = (jnp.asarray(pad_to(sl.sel, 0).reshape(nb, block, k)),
           jnp.asarray(pad_to(sl.rho, 0).reshape(nb, block, k)),
           jnp.asarray(pad_to(sl.valid, False).reshape(nb, block, k)))
    if len(cache) > 4:
        cache.clear()
    cache[key] = (dev, sl)
    return dev, sl


def _shortlist_starved(sl, obs_ok, s_cap):
    """True when any truncated row keeps fewer than s_cap valid
    candidates under this cycle's obs validity (the reference digs
    deeper than the shortlist there; callers must fall back)."""
    if not sl.truncated.any():
        return False
    cnt = (obs_ok[sl.sel] & sl.valid).sum(axis=1)
    return bool((sl.truncated & (cnt < s_cap)).any())


def _oi_points_shortlist(bpoints, background, bvariance, points, pobs,
                         pratios, pbackground, structure, max_points,
                         allow_extrapolation):
    """Accelerator OI from the canonical shortlist (see _oi_points).

    Returns (analysis, avariance) or None when any truncated gridpoint
    is starved this cycle (caller falls back to a full-depth path).
    """
    n_obs = points.size()
    k_cap = min(n_obs, max(2 * int(max_points), 16))
    sel_d, rho_d, val_d, tr_d, sl = _shortlist_dev(bpoints, points,
                                                   structure, k_cap)
    origin = _origin(bpoints)
    o_fields = _device_fields(points, structure, origin)
    block = max(16384, min(_BLOCK, (1 << 27) // max(sl.k_cap, 1)))
    kernel = make_oi_shortlist_sweep(structure, int(max_points),
                                     bool(allow_extrapolation), block)
    out_j, avar_j, starved = kernel(
        sel_d, rho_d, val_d, tr_d, o_fields,
        jnp.asarray(background), jnp.asarray(bvariance),
        jnp.asarray(pobs), jnp.asarray(pbackground),
        jnp.asarray(pratios))
    if int(np.asarray(starved)) > 0:
        return None
    return np.asarray(out_j), np.asarray(avar_j)


def _validate_oi(bobj, background, points, pobs, extra_vecs, names):
    if bobj.get_coordinate_type() != points.get_coordinate_type():
        raise ValueError(
            "Both background and observations points must be of same "
            "coordinate type (lat/lon or x/y)")
    if isinstance(bobj, Grid):
        gy, gx = bobj.size()
        if background.shape != (gy, gx):
            raise ValueError(
                f"input field ({background.shape[0]},{background.shape[1]}) "
                f"is not the same size as the grid ({gy},{gx})")
    else:
        if background.shape[0] != bobj.size():
            raise ValueError(
                f"Input field ({bobj.size()}) is not the same size as the "
                f"grid ({background.shape[0]})")
    if pobs.shape[0] != points.size():
        raise ValueError(
            f"Observations ({pobs.shape[0]}) and points ({points.size()}) "
            "size mismatch")
    for v, name in zip(extra_vecs, names):
        if v.shape[0] != points.size():
            raise ValueError(
                f"{name} ({v.shape[0]}) and points ({points.size()}) size "
                "mismatch")


def optimal_interpolation(bgrid, background, points, pobs, pratios,
                          pbackground, structure, max_points,
                          allow_extrapolation=True):
    """Deterministic OI (oi.cpp:26-136). Grid or Points background."""
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    background = asarray_f32(background, "background")
    pobs = asarray_f32(pobs, "pobs").ravel()
    pratios = asarray_f32(pratios, "pratios").ravel()
    pbackground = asarray_f32(pbackground, "pbackground").ravel()
    _validate_oi(bgrid, background, points, pobs,
                 (pratios, pbackground), ("Ratios", "Background"))
    is_grid = isinstance(bgrid, Grid)
    bpoints = bgrid.to_points() if is_grid else bgrid
    flat_bg = background.ravel()
    ones = np.ones_like(flat_bg)
    out, _ = _oi_points(bpoints, flat_bg, ones, points, pobs, pratios,
                        pbackground, np.ones_like(pratios), structure,
                        max_points, allow_extrapolation)
    return out.reshape(background.shape) if is_grid else out


def optimal_interpolation_full(bgrid, background, bvariance, points, obs,
                               obs_variance, background_at_points,
                               bvariance_at_points, structure, max_points,
                               allow_extrapolation=True):
    """Full OI with variances (oi.cpp:138-412).

    Returns (analysis, analysis_variance).
    """
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    background = asarray_f32(background, "background")
    bvariance = asarray_f32(bvariance, "bvariance")
    obs = asarray_f32(obs, "obs").ravel()
    obs_variance = asarray_f32(obs_variance, "obs_variance").ravel()
    background_at_points = asarray_f32(background_at_points,
                                       "background_at_points").ravel()
    bvariance_at_points = asarray_f32(bvariance_at_points,
                                      "bvariance_at_points").ravel()
    if background.shape != bvariance.shape:
        raise ValueError(
            f"Input bvariance ({bvariance.shape}) is not the same size as "
            f"the grid ({background.shape})")
    _validate_oi(bgrid, background, points, obs,
                 (obs_variance, background_at_points, bvariance_at_points),
                 ("Obs variance", "Background", "Background variance"))
    is_grid = isinstance(bgrid, Grid)
    bpoints = bgrid.to_points() if is_grid else bgrid
    out, avar = _oi_points(bpoints, background.ravel(), bvariance.ravel(),
                           points, obs, obs_variance, background_at_points,
                           bvariance_at_points, structure, max_points,
                           allow_extrapolation)
    if is_grid:
        return out.reshape(background.shape), avar.reshape(background.shape)
    return out, avar
