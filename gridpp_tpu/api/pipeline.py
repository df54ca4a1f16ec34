"""Fused post-processing pipeline: the production serving path.

The numpy-in/numpy-out functions round-trip every intermediate field
through host memory. Production pipelines (and the BASELINE north star)
chain downscale -> calibrate -> neighbourhood -> OI on the same grid every
forecast cycle; `Pipeline` compiles that chain into ONE device program
with all geometry device-resident, so a cycle costs a single
background-field upload and a single analysis download.

The expensive part of OI — evaluating the structure function against
every observation and keeping the top max_points (oi.cpp:221-281) — is
pure geometry: it depends on the grid, the obs network and the structure
function, none of which change between forecast cycles. `Pipeline`
therefore runs that selection ONCE at construction (on device) and caches
a per-gridpoint shortlist of the `candidates` highest-rho observations.
Each call then only masks candidates whose obs values are invalid this
cycle, re-selects the top max_points among survivors, assembles the
S x S local covariances and batch-solves. This matches the reference
exactly whenever at least max_points of the shortlisted candidates carry
valid observations (candidates > max_points provides the slack; a fully
static network with valid obs is bit-identical to the dense path).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import Statistic
from ..core.grid import Grid
from ..core.points import Points
from ..ops import neighbourhood as nops
from ..ops.canonical import canonical_shortlist
from ..ops.oi import oi_block_from_candidates
from ..ops.oi_ensi import _ensi_update
from ..ops import oi_tiled as tiled_ops
from .oi import _device_fields, _origin, _resolved_fields

__all__ = ["Pipeline", "EnsiPipeline", "MultiEnsiPipeline"]


class Pipeline:
    """Neighbourhood-smooth + deterministic OI, fused on device.

    Parameters mirror the individual API calls:
      grid: background Grid
      points: observation Points (static network)
      structure: StructureFunction for the OI
      halfwidth/statistic: neighbourhood filter settings (halfwidth=0
        disables smoothing)
      max_points: OI localization cap
      candidates: size of the cached geometric shortlist per gridpoint
        (>= max_points; the extra slots absorb observations that go
        missing in a given cycle). Default 2x max_points.
    """

    def __init__(self, grid: Grid, points: Points, structure,
                 halfwidth: int = 0, statistic: int = Statistic.Mean,
                 max_points: int = 10, allow_extrapolation: bool = True,
                 block: int = 16384, candidates: int | None = None,
                 tiled: bool | None = None, tile_shape=(32, 64),
                 ratios=None):
        self.grid = grid
        self.points = points
        self.structure = structure
        self.shape = tuple(grid.size())
        bpoints = grid.to_points()
        origin = _origin(bpoints)
        obs_fields = self._obs_fields = _device_fields(points, structure,
                                                       origin)
        # device gather map: grid cell containing each obs point
        obs_nn = self._obs_nn = jnp.asarray(
            grid.nearest_map(points.lats, points.lons, cache_obj=points))
        n = self.shape[0] * self.shape[1]
        n_obs = points.size()
        halfwidth = int(halfwidth)
        statistic = int(statistic)
        max_points = int(max_points)
        allow = bool(allow_extrapolation)
        if candidates is None:
            candidates = 2 * max_points if max_points > 0 else n_obs
        k_cap = max(1, min(int(candidates), n_obs))

        # One-time geometric selection (the OI hot loop's radius query +
        # top-k, oi.cpp:221-281, amortized across cycles). CANONICAL
        # host evaluation (ops/canonical.py): the stored order and rho
        # bits are identical to the host API's per-call selection, so
        # serving matches the plain API exactly whenever >= max_points
        # shortlisted candidates carry valid obs.
        sl = canonical_shortlist(bpoints, points, structure, k_cap)

        self._static_w = None
        # keep construction-time ratios as the default for cycles that
        # don't pass pratios (the flat path has no static-weight table,
        # so it serves them through the general solve)
        self._init_ratios = (None if ratios is None
                             else np.asarray(ratios, np.float32))
        if tiled is None:
            # tile tables win once the grid is large enough to amortize
            # the table build; tiny grids keep the flat path
            tiled = n >= 65536
        if tiled:
            self._init_tiled(sl.sel, sl.rho, sl.valid, points, structure,
                             halfwidth, statistic, max_points, allow,
                             tile_shape, origin, ratios)
            return

        sel = jnp.asarray(sl.sel)
        rho = jnp.asarray(sl.rho)
        valid = jnp.asarray(sl.valid)
        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v, fill):
            if not pad:
                return v
            return jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:], fill, v.dtype)])

        # Padded + pre-blocked shortlist, kept device-resident across calls.
        self._cand = jax.block_until_ready((
            pad_to(sel, 0).reshape(nb, block, k_cap),
            pad_to(rho, 0).reshape(nb, block, k_cap),
            pad_to(valid, False).reshape(nb, block, k_cap)))
        shape = self.shape
        struct = structure

        @jax.jit
        def run(background, pobs, pratios, sel_c, rho_c, val_c,
                obs_fields, obs_nn):
            smoothed = background
            if halfwidth > 0:
                smoothed = nops.neighbourhood(background, halfwidth,
                                               statistic)
            flat = smoothed.reshape(-1)
            pback = jnp.take(flat, obs_nn)
            bg = pad_to(flat, jnp.nan).reshape(nb, block)

            def body(args):
                selc, rhoc, valc, bgc = args
                out, _ = oi_block_from_candidates(
                    struct, selc, rhoc, valc, obs_fields, bgc,
                    jnp.ones_like(bgc), pobs, pback, pratios,
                    max_points, allow)
                return out

            out = jax.lax.map(body, (sel_c, rho_c, val_c, bg))
            return out.reshape(-1)[:n].reshape(shape)

        self._run = lambda b, o, r: run(b, o, r, *self._cand,
                                        self._obs_fields, self._obs_nn)

    def _init_tiled(self, sel, rho, valid, points, structure, halfwidth,
                    statistic, max_points, allow, tile_shape, origin,
                    ratios=None):
        """Tile-union serving path (ops/oi_tiled.py)."""
        static_np = _resolved_fields(points, structure, origin)
        geom = tiled_ops.build_tile_tables(
            np.asarray(sel), np.asarray(rho), np.asarray(valid),
            static_np, self.shape, th=tile_shape[0], tw=tile_shape[1])
        geom_dev = {
            "tile_table": jnp.asarray(geom.tile_table),
            "local_idx": jnp.asarray(geom.local_idx),
            "rho": jnp.asarray(geom.rho),
            "valid": jnp.asarray(geom.valid),
            "tile_static": jnp.asarray(geom.tile_static),
        }
        self._geom = geom
        self._geom_dev = jax.block_until_ready(geom_dev)
        static_keys = tuple(geom.static_keys)
        obs_nn = self._obs_nn
        struct = structure
        shape = self.shape

        @jax.jit
        def run(background, pobs, pratios, gdev):
            smoothed = background
            if halfwidth > 0:
                smoothed = nops.neighbourhood(background, halfwidth,
                                               statistic)
            flat = smoothed.reshape(-1)
            pback = jnp.take(flat, obs_nn)
            valid01 = (jnp.isfinite(pobs)
                       & jnp.isfinite(pback)).astype(jnp.float32)
            packed = jnp.stack(
                [jnp.where(valid01 > 0, pobs, 0.0),
                 jnp.where(valid01 > 0, pback, 0.0),
                 pratios, valid01], axis=1)
            bg_t = tiled_ops.tile_fields(smoothed, geom)
            out_t, _ = tiled_ops.oi_tiled_sweep(
                struct, gdev, static_keys, bg_t, jnp.ones_like(bg_t),
                packed, max_points, allow)
            return tiled_ops.untile_fields(out_t, geom).reshape(shape)

        self._jit_general = run
        self._run_general = lambda b, o, r: run(b, o, r, self._geom_dev)
        self._run = self._run_general

        # Guarded general path: the cycle's expensive half (top-k
        # re-selection + S x S solve) depends only on (obs validity,
        # ratios). Cache the solved weights table device-side and
        # refresh it under lax.cond only when a device guard sees the
        # validity or ratios change — the common static-network cycle
        # then costs one innovation paging + weighted sum (the fast
        # path's kernel), with NO host synchronization in the loop.
        # Identical output to the full re-solve: build_weights_dynamic
        # shares oi_tiled_sweep's selection and solve, and one-hot
        # paging of innovations is an exact pick.
        n_obs = self.points.size()
        tile_table = self._geom_dev["tile_table"]
        s_cap = (min(max_points, self._geom.k_cap) if max_points > 0
                 else self._geom.k_cap)
        t_count, tb, _ = self._geom_dev["local_idx"].shape

        @jax.jit
        def run_guarded(background, pobs, pratios, gdev, state):
            smoothed = background
            if halfwidth > 0:
                smoothed = nops.neighbourhood(background, halfwidth,
                                               statistic)
            flat = smoothed.reshape(-1)
            pback = jnp.take(flat, obs_nn)
            valid01 = (jnp.isfinite(pobs)
                       & jnp.isfinite(pback)).astype(jnp.float32)
            changed = ((state["init"] == 0)
                       | jnp.any(valid01 != state["valid"])
                       | jnp.any(pratios != state["ratios"]))

            def rebuild(_):
                sw = tiled_ops.build_weights_dynamic(
                    struct, gdev, static_keys, pratios, valid01,
                    max_points)
                return sw["local_s"], sw["valid_s"], sw["weights"]

            def keep(_):
                return (state["local_s"], state["valid_s"],
                        state["weights"])

            local_s, valid_s, weights = jax.lax.cond(changed, rebuild,
                                                     keep, None)
            innov = jnp.where(valid01 > 0, pobs - pback, 0.0)
            bg_t = tiled_ops.tile_fields(smoothed, geom)
            out_t = tiled_ops.oi_tiled_apply_weights(
                {"local_s": local_s, "valid_s": valid_s,
                 "weights": weights},
                gdev["tile_table"], bg_t, innov, allow)
            out = tiled_ops.untile_fields(out_t, geom).reshape(shape)
            new_state = {"init": jnp.int32(1), "valid": valid01,
                         "ratios": pratios, "local_s": local_s,
                         "valid_s": valid_s, "weights": weights}
            return out, new_state

        def zero_state():
            return {
                "init": jnp.int32(0),
                "valid": jnp.zeros(n_obs, jnp.float32),
                "ratios": jnp.zeros(n_obs, jnp.float32),
                "local_s": jnp.zeros((t_count, tb, s_cap), jnp.int32),
                "valid_s": jnp.zeros((t_count, tb, s_cap), bool),
                "weights": jnp.zeros((t_count, tb, s_cap), jnp.float32),
            }

        self._gw_state = None

        def run_general_guarded(b, o, r):
            if self._gw_state is None:
                self._gw_state = zero_state()
            out, self._gw_state = run_guarded(b, o, r, self._geom_dev,
                                              self._gw_state)
            return out

        self._run = run_general_guarded

        if ratios is not None:
            # Static-network fast path: the whole per-gridpoint solve is
            # geometry once ratios are fixed; a cycle is one weighted sum.
            self._init_ratios = np.asarray(ratios, np.float32)
            self._static_w = jax.block_until_ready(
                tiled_ops.build_static_weights(
                    structure, self._geom_dev, static_keys,
                    jnp.asarray(self._init_ratios), max_points))

            @jax.jit
            def run_fast(background, pobs, sw, tile_table):
                smoothed = background
                if halfwidth > 0:
                    smoothed = nops.neighbourhood(background, halfwidth,
                                                  statistic)
                flat = smoothed.reshape(-1)
                innov = pobs - jnp.take(flat, obs_nn)
                bg_t = tiled_ops.tile_fields(smoothed, geom)
                out_t = tiled_ops.oi_tiled_apply_weights(
                    sw, tile_table, bg_t, innov, allow)
                return tiled_ops.untile_fields(out_t, geom).reshape(shape)

            self._jit_fast = run_fast
            self._run_fast = lambda b, o: run_fast(
                b, o, self._static_w, self._geom_dev["tile_table"])

    def _fast_eligible(self, pratios):
        return self._static_w is not None and (
            pratios is None
            or np.array_equal(np.asarray(pratios, np.float32),
                              self._init_ratios))

    def __call__(self, background, pobs, pratios=None):
        """background: (Y, X); pobs/pratios: (P,). Returns (Y, X).

        pratios may be omitted when the Pipeline was built with `ratios`.
        """
        bg_np = np.asarray(background, np.float32)
        po_np = np.asarray(pobs, np.float32)
        # validity checked host-side: no device round-trip
        assume_valid = bool(np.isfinite(po_np).all()
                            and np.isfinite(bg_np).all())
        return np.asarray(self.run_device(
            jnp.asarray(bg_np), jnp.asarray(po_np), pratios,
            assume_valid=assume_valid))

    def run_device(self, background, pobs, pratios=None,
                   assume_valid=False, path="auto"):
        """Device-to-device variant (no host transfers).

        assume_valid=True skips the all-finite device check (one scalar
        sync) when the caller has already validated the cycle's inputs —
        required for async streaming of back-to-back cycles.
        path: "auto" (fast when eligible), "fast" (require the static-
        ratios weight path), "general" (the dynamic-network serving
        path: on tiled grids a device-guarded weights cache rebuilt only
        when obs validity or ratios change), or "resolve" (force the
        full tiled re-solve every cycle, e.g. to benchmark the
        cache-miss cost).
        """
        if path in ("general", "resolve"):
            if pratios is None:
                pratios = self._init_ratios
            if pratios is None:
                raise ValueError("pratios required for the general path")
            pratios = jnp.asarray(np.asarray(pratios, np.float32))
            if path == "resolve" and hasattr(self, "_run_general"):
                return self._run_general(background, pobs, pratios)
            return self._run(background, pobs, pratios)
        if path == "fast" and self._static_w is None:
            raise ValueError("Pipeline was built without static ratios")
        if self._fast_eligible(pratios):
            if assume_valid or bool(
                    jnp.isfinite(pobs).all()
                    & jnp.isfinite(background).all()):
                return self._run_fast(background, pobs)
        if pratios is None:
            pratios = self._init_ratios
        if pratios is None:
            raise ValueError("pratios required (Pipeline built without "
                             "ratios)")
        pratios = jnp.asarray(np.asarray(pratios, np.float32))
        return self._run(background, pobs, pratios)

    def lower(self, background, pobs, path="fast"):
        """The lowered device program of one cycle (jax.stages.Lowered),
        e.g. for `.compile().memory_analysis()`.

        path: "fast" or "resolve", both with the ratios the Pipeline
        was built with; tiled grids only.
        """
        if path == "fast" and self._static_w is not None:
            return self._jit_fast.lower(background, pobs, self._static_w,
                                        self._geom_dev["tile_table"])
        if (path == "resolve" and hasattr(self, "_jit_general")
                and self._init_ratios is not None):
            return self._jit_general.lower(
                background, pobs, jnp.asarray(self._init_ratios),
                self._geom_dev)
        raise ValueError(f"no {path!r} program: lower() covers the fast "
                         "and resolve paths of a tiled Pipeline built "
                         "with ratios")

    def serve_stream(self, cycles):
        """Pipelined serving over an iterable of host cycles
        (background, pobs[, pratios]); yields (Y, X) numpy analyses in
        order. Cycle N's download overlaps cycle N+1's upload+compute
        (see _serve_stream)."""
        def run_one(args):
            bg = np.asarray(args[0], np.float32)
            po = np.asarray(args[1], np.float32)
            pr = args[2] if len(args) > 2 else None
            ok = bool(np.isfinite(po).all() and np.isfinite(bg).all())
            return self.run_device(jnp.asarray(bg), jnp.asarray(po), pr,
                                   assume_valid=ok)

        return _serve_stream(run_one, cycles)


def _serve_stream(run_one, cycles, to_host=np.asarray):
    """Pipelined serving loop: H2D of cycle N+1 and compute of N+1 are
    dispatched BEFORE cycle N's output download, so the download (the
    dominant cost on slow links) overlaps the next cycle's compute and
    the device never idles waiting for the host.

    bench.py times this loop against a serial upload->compute->download
    loop (*_serving_overlapped_pts_per_s vs *_serving_serial_pts_per_s).

    run_one: callable(host_args_tuple) -> device output (async dispatch).
    cycles: iterable of host argument tuples. Yields host outputs in
    order.
    """
    prev = None
    for args in cycles:
        out = run_one(args)
        if prev is not None:
            yield to_host(prev)
        prev = out
    if prev is not None:
        yield to_host(prev)


class EnsiPipeline:
    """Ensemble OI (EnSI) serving path, fused on device.

    BASELINE's north star is 2000^2 *ensemble* OI with 10k observations;
    this is its production entry point. Same design as `Pipeline`: the
    per-gridpoint top-rho candidate shortlist (the radius query + top-k
    of oi_ensi.cpp:207-269) is pure geometry, computed ONCE on device at
    construction; a forecast cycle then only uploads the member fields
    and obs vectors, masks candidates with invalid obs, re-selects the
    top max_points, and runs the batched local ensemble transform
    (eigh of the E x E Pinv, ops/oi_ensi._ensi_update) in one program.
    Matches optimal_interpolation_ensi whenever >= max_points shortlist
    candidates carry valid obs (candidates > max_points is the slack).

    The per-member neighbourhood smoothing stage (halfwidth > 0) runs
    as one stencil over the member stack. pbackground at the obs points is
    gathered on device from the (smoothed) background via the cached
    nearest map, as the reference CLI's OI calibrator interpolates it.
    """

    def __init__(self, grid: Grid, points: Points, structure,
                 halfwidth: int = 0, statistic: int = Statistic.Mean,
                 max_points: int = 10, allow_extrapolation: bool = True,
                 block: int = 16384, candidates: int | None = None):
        self.grid = grid
        self.points = points
        self.structure = structure
        self.shape = tuple(grid.size())
        bpoints = grid.to_points()
        origin = _origin(bpoints)
        obs_fields = _device_fields(points, structure, origin)
        self._obs_nn = jnp.asarray(
            grid.nearest_map(points.lats, points.lons, cache_obj=points))
        n = self.shape[0] * self.shape[1]
        n_obs = points.size()
        halfwidth = int(halfwidth)
        statistic = int(statistic)
        max_points = int(max_points)
        allow = bool(allow_extrapolation)
        if candidates is None:
            candidates = 2 * max_points if max_points > 0 else n_obs
        k_cap = max(1, min(int(candidates), n_obs))

        # canonical host selection: bit-identical order/rho to the host
        # API's per-call selection (ops/canonical.py)
        sl = canonical_shortlist(bpoints, points, structure, k_cap)
        sel = jnp.asarray(sl.sel)
        rho = jnp.asarray(sl.rho)
        valid = jnp.asarray(sl.valid)

        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v, fill):
            if not pad:
                return v
            return jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:], fill, v.dtype)])

        self._cand = jax.block_until_ready((
            pad_to(sel, 0).reshape(nb, block, k_cap),
            pad_to(rho, 0).reshape(nb, block, k_cap),
            pad_to(valid, False).reshape(nb, block, k_cap)))
        shape = self.shape
        struct = structure
        s_cap = min(max_points, k_cap) if max_points > 0 else k_cap
        obs_nn = self._obs_nn
        # Static-prefix selection for the all-valid fast path: the
        # shortlist is sorted by rho (top_k in make_oi_select_sweep), so
        # with every obs valid the per-cycle top_k re-selection returns
        # exactly the first s_cap entries - precompute them and skip the
        # masking + top_k + index indirection entirely (bit-identical
        # output).
        self._cand_fast = jax.block_until_ready(
            (self._cand[0][:, :, :s_cap], self._cand[1][:, :, :s_cap],
             self._cand[2][:, :, :s_cap]))

        def smooth_members(background):
            # one stencil over the (E, Y, X) stack: leading axes broadcast
            out = nops.neighbourhood(jnp.moveaxis(background, 2, 0),
                                     halfwidth, statistic)
            return jnp.moveaxis(out, 0, 2)

        @jax.jit
        def run(background, pobs, psigmas, sel_c, rho_c, val_c, obs_nn):
            # background: (Y, X, E)
            e = background.shape[-1]
            smoothed = background
            if halfwidth > 0:
                smoothed = smooth_members(background)
            flat = smoothed.reshape(n, e)
            pback = jnp.take(flat, obs_nn, axis=0)  # (P, E)
            fin = jnp.isfinite(pback)
            cnt = jnp.sum(fin, axis=1)
            y_hat = jnp.where(
                cnt > 0,
                jnp.sum(jnp.where(fin, pback, 0.0), axis=1)
                / jnp.maximum(cnt, 1), jnp.nan)
            y_anom = jnp.where(fin & jnp.isfinite(y_hat)[:, None],
                               pback - y_hat[:, None], pback)
            obs_ok = jnp.isfinite(pobs)
            # one packed per-obs table (see run_fast): a single
            # (B, S, padw)-row gather replaces four obs-indexed gathers
            padw = -(-(e + 3) // 8) * 8
            tab = jnp.concatenate(
                [pobs[:, None], psigmas[:, None], y_hat[:, None], y_anom,
                 jnp.zeros((n_obs, padw - (e + 3)), jnp.float32)], axis=1)
            bg = pad_to(flat, jnp.nan).reshape(nb, block, e)

            def body(args):
                selc, rhoc, valc, bgc = args
                v = valc & jnp.take(obs_ok, selc, axis=0)
                vals, sub = jax.lax.top_k(
                    jnp.where(v, rhoc, -jnp.inf), s_cap)
                sel_valid = jnp.isfinite(vals)
                l_rho = jnp.where(sel_valid, vals, 0.0).astype(jnp.float32)
                g = jnp.take_along_axis(selc, sub, axis=1)
                f = jnp.take(tab, g, axis=0)  # (B, S, padw)
                out, cond_bad = _ensi_update(
                    struct, sel_valid, l_rho, f[:, :, 0], f[:, :, 1],
                    f[:, :, 3:3 + e], f[:, :, 2], bgc, allow)
                return out, cond_bad

            out, cond_bad = jax.lax.map(body, (sel_c, rho_c, val_c, bg))
            return (out.reshape(-1, e)[:n].reshape(shape + (e,)),
                    jnp.sum(cond_bad.reshape(-1)[:n]))

        @jax.jit
        def run_fast(background, pobs, psigmas, g_s, rho_s, v_s, obs_nn):
            # all-valid cycle: selection is the precomputed shortlist
            # prefix; no masking, no top_k
            e = background.shape[-1]
            smoothed = background
            if halfwidth > 0:
                smoothed = smooth_members(background)
            flat = smoothed.reshape(n, e)
            pback = jnp.take(flat, obs_nn, axis=0)  # (P, E)
            # same reduction expression as the general path so the fast
            # path is bit-identical, not just close
            fin = jnp.isfinite(pback)
            cnt = jnp.sum(fin, axis=1)
            y_hat = jnp.where(
                cnt > 0,
                jnp.sum(jnp.where(fin, pback, 0.0), axis=1)
                / jnp.maximum(cnt, 1), jnp.nan)
            y_anom = jnp.where(fin & jnp.isfinite(y_hat)[:, None],
                               pback - y_hat[:, None], pback)
            # ONE packed per-obs table [obs, sig, yhat, y_anom..] padded
            # to a multiple of 8 columns: a single (B, S, 16)-row gather
            # replaces the four separate obs-indexed gathers
            padw = -(-(e + 3) // 8) * 8
            tab = jnp.concatenate(
                [pobs[:, None], psigmas[:, None], y_hat[:, None], y_anom,
                 jnp.zeros((n_obs, padw - (e + 3)), jnp.float32)], axis=1)
            bg = pad_to(flat, jnp.nan).reshape(nb, block, e)

            def body(args):
                g, rho, v, bgc = args
                l_rho = jnp.where(v, rho, 0.0)
                f = jnp.take(tab, g, axis=0)  # (B, S, padw)
                return _ensi_update(struct, v, l_rho, f[:, :, 0],
                                    f[:, :, 1], f[:, :, 3:3 + e],
                                    f[:, :, 2], bgc, allow)

            out, cond_bad = jax.lax.map(body, (g_s, rho_s, v_s, bg))
            return (out.reshape(-1, e)[:n].reshape(shape + (e,)),
                    jnp.sum(cond_bad.reshape(-1)[:n]))

        self._run = lambda b, o, s: run(b, o, s, *self._cand,
                                        self._obs_nn)
        self._run_fast = lambda b, o, s: run_fast(
            b, o, s, *self._cand_fast, self._obs_nn)

    def run_device(self, background, pobs, psigmas, assume_valid=False):
        """Device-to-device cycle: background (Y, X, E) jax.Array,
        pobs/psigmas (P,). Returns (analysis (Y, X, E), n_cond_failures
        device scalar).

        assume_valid=True asserts every obs, sigma and background value
        is finite this cycle; the per-cycle top-k re-selection then
        reduces to the precomputed shortlist prefix (bit-identical).
        Callers streaming cycles should validate host-side and pass it
        (as bench.py does).
        """
        if assume_valid:
            return self._run_fast(background, pobs, psigmas)
        return self._run(background, pobs, psigmas)

    def __call__(self, background, pobs, psigmas):
        """numpy convenience wrapper (one upload, one download)."""
        bg_np = np.asarray(background, np.float32)
        po_np = np.asarray(pobs, np.float32)
        ps_np = np.asarray(psigmas, np.float32)
        valid = bool(np.isfinite(bg_np).all() and np.isfinite(po_np).all()
                     and np.isfinite(ps_np).all())
        out, _ = self.run_device(jnp.asarray(bg_np), jnp.asarray(po_np),
                                 jnp.asarray(ps_np), assume_valid=valid)
        return np.asarray(out)

    def serve_stream(self, cycles):
        """Pipelined serving over an iterable of host cycles
        (background, pobs, psigmas); yields (Y, X, E) numpy analyses in
        order, overlapping each cycle's download with the next cycle's
        upload+compute (see _serve_stream)."""
        def run_one(args):
            bg, po, ps = (np.asarray(a, np.float32) for a in args)
            valid = bool(np.isfinite(bg).all() and np.isfinite(po).all()
                         and np.isfinite(ps).all())
            out, _ = self.run_device(jnp.asarray(bg), jnp.asarray(po),
                                     jnp.asarray(ps), assume_valid=valid)
            return out

        return _serve_stream(run_one, cycles)


class MultiEnsiPipeline:
    """Device serving path for the ensi_multi family (ebe/ebesc/utem).

    Same shortlist design as EnsiPipeline: the per-gridpoint top-rho
    candidate selection (the radius query + top-k of
    oi_ensi_multi.cpp:446-523) is computed ONCE on device at
    construction; each forecast cycle uploads only the member fields and
    obs vectors, masks candidates with invalid obs, re-selects the top
    max_points and runs the batch-last member/ETKF update
    (ops/oi_ensi_multi.make_member_serve_sweep / make_utem_serve_sweep).
    pbackground (and pbackground_corr) at the obs points are gathered on
    device from the background via the cached nearest map.

    Matches the host API (optimal_interpolation_ensi_multi_*) when every
    member is valid at every gridpoint and >= max_points shortlist
    candidates carry valid obs.
    """

    def __init__(self, grid: Grid, points: Points, structure,
                 variant: str = "ebesc", max_points: int = 10,
                 allow_extrapolation: bool = True, block: int = 16384,
                 candidates: int | None = None, bratios=None):
        from ..ops import oi_ensi_multi as mops

        if variant not in ("ebe", "ebesc", "utem"):
            raise ValueError("variant must be one of ebe/ebesc/utem")
        self.variant = variant
        self.grid = grid
        self.points = points
        self.structure = structure
        self.shape = tuple(grid.size())
        bpoints = grid.to_points()
        origin = _origin(bpoints)
        obs_fields = _device_fields(points, structure, origin)
        self._obs_nn = jnp.asarray(
            grid.nearest_map(points.lats, points.lons, cache_obj=points))
        n = self.shape[0] * self.shape[1]
        self._n = n
        n_obs = points.size()
        max_points = int(max_points)
        allow = bool(allow_extrapolation)
        if candidates is None:
            candidates = 2 * max_points if max_points > 0 else n_obs
        k_cap = max(1, min(int(candidates), n_obs))
        s_cap = min(max_points, k_cap) if max_points > 0 else k_cap

        # canonical host selection (ops/canonical.py): selection order
        # and rho bits shared with the host API paths
        sl = canonical_shortlist(bpoints, points, structure, k_cap)
        sel = jnp.asarray(sl.sel)
        rho = jnp.asarray(sl.rho)
        valid = jnp.asarray(sl.valid)
        nb = -(-n // block)
        pad = nb * block - n

        def pad_to(v, fill):
            if not pad:
                return v
            return jnp.concatenate(
                [v, jnp.full((pad,) + v.shape[1:], fill, v.dtype)])

        self._cand = jax.block_until_ready((
            pad_to(sel, 0).reshape(nb, block, k_cap),
            pad_to(rho, 0).reshape(nb, block, k_cap),
            pad_to(valid, False).reshape(nb, block, k_cap)))
        if bratios is None:
            br = jnp.ones(n, jnp.float32)
        else:
            br = jnp.asarray(np.asarray(bratios, np.float32).reshape(-1))
            if br.shape[0] != n:
                raise ValueError("Bratios and grid size mismatch")
        self._bratios = br
        self._field_keys = tuple(obs_fields)
        self._obs_tab_fields = jnp.stack(
            [obs_fields[k] for k in self._field_keys], axis=1)  # (P, F)
        f = len(self._field_keys)
        obs_nn = self._obs_nn
        shape = self.shape

        if variant == "utem":
            sweep = mops.make_utem_serve_sweep(structure, s_cap, block,
                                               allow)

            @jax.jit
            def cycle(bg3, bgc3, pobs, pratios, cand, br_d):
                e = bg3.shape[-1]
                bg = bg3.reshape(n, e)
                bgc = bgc3.reshape(n, e)
                pback = jnp.take(bg, obs_nn, axis=0)     # (P, E)
                pbackc = jnp.take(bgc, obs_nn, axis=0)
                y_hat = jnp.mean(pback, axis=1)
                y_anom = jnp.where(jnp.isfinite(y_hat)[:, None],
                                   pback - y_hat[:, None], 0.0)
                y_corr = mops.norm_anom_jnp(pbackc)
                w = 3 + 2 * e
                padw = -(-w // 8) * 8
                tab = jnp.concatenate(
                    [pobs[:, None], pratios[:, None], y_hat[:, None],
                     y_anom, y_corr,
                     jnp.zeros((n_obs, padw - w), jnp.float32)], axis=1)
                obs_ok = jnp.isfinite(pobs)
                out, cond_bad = sweep(bg, bgc, br_d, tab, obs_ok, *cand)
                return out.reshape(shape + (e,)), cond_bad

            self._cycle = cycle
        else:
            use_z = variant == "ebe"
            sweep = mops.make_member_serve_sweep(
                structure, self._field_keys, s_cap, block, allow, use_z)
            tabf = self._obs_tab_fields

            @jax.jit
            def cycle(bg3, bgc3, pobs, pratios, cand, br_d):
                e = bg3.shape[-1]
                bg = bg3.reshape(n, e)
                pback = jnp.take(bg, obs_nn, axis=0)   # (P, E)
                innov = pobs - pback
                cols = [tabf, pratios[:, None], innov]
                if use_z:
                    bgc = bgc3.reshape(n, e)
                    x_l = mops.norm_anom_jnp(bgc)
                    z_r = mops.norm_anom_jnp(
                        jnp.take(bgc, obs_nn, axis=0))
                    cols.append(z_r)
                else:
                    x_l = jnp.zeros((1, 1), jnp.float32)
                w = f + 1 + (2 if use_z else 1) * e
                padw = -(-w // 8) * 8
                cols.append(jnp.zeros((n_obs, padw - w), jnp.float32))
                tab = jnp.concatenate(cols, axis=1)
                obs_ok = jnp.isfinite(pobs[:, 0])
                out = sweep(bg, br_d, x_l, tab, obs_ok, *cand)
                return out.reshape(shape + (e,)), jnp.int32(0)

            self._cycle = cycle

    def run_device(self, background, pobs, pratios, background_corr=None):
        """One cycle, device-to-device.

        background: (Y, X, E). pobs: (P, E) for ebe/ebesc, (P,) for utem.
        pratios: (P,). background_corr: (Y, X, E), required for ebe and
        utem (the dynamic-correlation ensemble); ignored for ebesc.
        Returns (analysis (Y, X, E), n_condition_failures device scalar).
        """
        if self.variant in ("ebe", "utem"):
            if background_corr is None:
                raise ValueError(
                    f"background_corr required for {self.variant}")
            bgc = background_corr
        else:
            bgc = background
        return self._cycle(background, bgc, pobs, pratios, self._cand,
                           self._bratios)

    def __call__(self, background, pobs, pratios, background_corr=None):
        """numpy convenience wrapper (one upload, one download)."""
        out, _ = self.run_device(
            jnp.asarray(np.asarray(background, np.float32)),
            jnp.asarray(np.asarray(pobs, np.float32)),
            jnp.asarray(np.asarray(pratios, np.float32)),
            None if background_corr is None else
            jnp.asarray(np.asarray(background_corr, np.float32)))
        return np.asarray(out)

    def serve_stream(self, cycles):
        """Pipelined serving over an iterable of host cycles
        (background, pobs, pratios[, background_corr]); yields
        (Y, X, E) numpy analyses in order (see _serve_stream)."""
        def run_one(args):
            bgc = args[3] if len(args) > 3 else None
            out, _ = self.run_device(
                jnp.asarray(np.asarray(args[0], np.float32)),
                jnp.asarray(np.asarray(args[1], np.float32)),
                jnp.asarray(np.asarray(args[2], np.float32)),
                None if bgc is None else
                jnp.asarray(np.asarray(bgc, np.float32)))
            return out

        return _serve_stream(run_one, cycles)
