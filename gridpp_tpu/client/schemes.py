"""Downscalers and calibrators for the CLI pipeline.

Class-based wrappers over the library API, operating on File objects
(reference src/client/Downscaler/*, src/client/Calibrator/*). Fields are
(T, Y, X, E) arrays.
"""
from __future__ import annotations

import numpy as np

import gridpp_tpu as gridpp
from ..constants import MV
from .options import Options

# ---------------------------------------------------------------------------
# Downscalers
# ---------------------------------------------------------------------------


class Downscaler:
    def __init__(self, variable, options: Options, input_variable=None):
        self.variable = variable                # output variable name
        self.input_variable = input_variable or variable  # -vi support
        self.options = options

    def downscale(self, ifile, ofile):
        field = ifile.get_field(self.input_variable)  # (T, Y, X, E)
        nt, ny, nx, ne = field.shape
        oy, ox = ofile.grid.size()
        out = np.full((nt, oy, ox, ne), MV, np.float32)
        # (T*E, Y, X) batch through the gather kernels in one call
        batch = np.transpose(field, (0, 3, 1, 2)).reshape(nt * ne, ny, nx)
        res = self._apply(ifile.grid, ofile.grid, batch)
        out = np.transpose(res.reshape(nt, ne, oy, ox), (0, 2, 3, 1))
        ofile.add_field(self.variable, out)

    def _apply(self, igrid, ogrid, batch):
        raise NotImplementedError

    @staticmethod
    def get_scheme(name, variable, options: Options, input_variable=None):
        schemes = {
            "nearestNeighbour": DownscalerNearestNeighbour,
            "nearest": DownscalerNearestNeighbour,
            "bilinear": DownscalerBilinear,
            "gradient": DownscalerGradient,
            "bypass": DownscalerBypass,
            "upscale": DownscalerUpscale,
            "pressure": DownscalerPressure,
            "smart": DownscalerSmart,
        }
        if name not in schemes:
            raise RuntimeError(
                f"Could not instantiate downscaler of type '{name}'")
        return schemes[name](variable, options,
                             input_variable=input_variable)


class DownscalerNearestNeighbour(Downscaler):
    def _apply(self, igrid, ogrid, batch):
        return gridpp.nearest(igrid, ogrid, batch)


class DownscalerBilinear(Downscaler):
    def _apply(self, igrid, ogrid, batch):
        return gridpp.bilinear(igrid, ogrid, batch)


class DownscalerGradient(Downscaler):
    """Elevation-gradient downscaler (Downscaler/Gradient.cpp), using the
    library's simple_gradient with a configurable constant gradient."""

    def _apply(self, igrid, ogrid, batch):
        elev_gradient = self.options.get("constantGradient", -0.0065, float)
        return gridpp.simple_gradient(igrid, ogrid, batch, elev_gradient)


class DownscalerBypass(Downscaler):
    """Skip downscaling (Downscaler/Bypass.cpp): used when the variable
    will be diagnosed by a calibrator. Copies when the input has the
    variable; otherwise initializes an MV field in the output."""

    def downscale(self, ifile, ofile):
        if ifile.has_variable(self.input_variable):
            ofile.add_field(self.variable,
                            ifile.get_field(self.input_variable))
        elif not ofile.has_variable(self.variable):
            ny, nx = ofile.grid.size()
            nt = len(ofile.times)
            ofile.add_field(self.variable,
                            np.full((nt, ny, nx, ofile.num_ens), MV,
                                    np.float32))


class DownscalerUpscale(Downscaler):
    """Mean of input cells nearest to each output cell
    (Downscaler/Upscale.cpp)."""

    def _apply(self, igrid, ogrid, batch):
        ipoints = igrid.to_points()
        out = []
        for field in batch:
            out.append(gridpp.gridding_nearest(ogrid, ipoints,
                                               field.ravel(), 0,
                                               gridpp.Mean))
        return np.stack(out)


class DownscalerPressure(Downscaler):
    """Nearest + hydrostatic elevation adjustment
    (Downscaler/Pressure.cpp)."""

    def _apply(self, igrid, ogrid, batch):
        near = gridpp.nearest(igrid, ogrid, batch)
        delev = gridpp.nearest(igrid, ogrid, igrid.get_elevs())
        oelev = ogrid.get_elevs()
        valid = np.isfinite(delev) & np.isfinite(oelev)
        out = np.where(valid,
                       gridpp.pressure(np.where(valid, delev, 0).ravel(),
                                       np.where(valid, oelev, 0).ravel(),
                                       np.nan_to_num(near.reshape(
                                           len(batch), -1)).ravel(),
                                       np.full(near.size, 288.15,
                                               np.float32)).reshape(
                                                   near.shape),
                       near)
        return out.astype(np.float32)


class DownscalerSmart(Downscaler):
    """Smart neighbours using elevation similarity via BarnesStructure."""

    def _apply(self, igrid, ogrid, batch):
        num = self.options.get("numSmart", 5, int)
        radius_km = self.options.get("searchRadius", 3, int)
        # approximate the legacy radius (gridpoints) with a length scale
        h = max(radius_km, 1) * 10000.0
        structure = gridpp.BarnesStructure(h, 100.0)
        out = [gridpp.smart(igrid, ogrid, f, num, structure) for f in batch]
        return np.stack(out)


# ---------------------------------------------------------------------------
# Calibrators
# ---------------------------------------------------------------------------


class Calibrator:
    def __init__(self, variable, options: Options):
        self.variable = variable
        self.options = options

    def calibrate(self, ofile, parameter_file=None):
        raise NotImplementedError

    @staticmethod
    def shuffle(raw, cal):
        """Rank-preserving reorder of calibrated members
        (Calibrator.cpp:105-130): member e keeps the rank it had in the
        raw ensemble. Vectorized over leading axes; any invalid member
        in a cell leaves that cell's calibrated values unshuffled."""
        ranks = np.argsort(np.argsort(raw, axis=-1, kind="stable"),
                           axis=-1, kind="stable")
        shuffled = np.take_along_axis(np.sort(cal, axis=-1), ranks, axis=-1)
        ok = (np.isfinite(raw).all(axis=-1) &
              np.isfinite(cal).all(axis=-1))[..., None]
        return np.where(ok, shuffled, cal)

    @staticmethod
    def get_scheme(name, variable, options: Options):
        schemes = {
            "accumulate": CalibratorAccumulate,
            "deaccumulate": CalibratorDeaccumulate,
            "neighbourhood": CalibratorNeighbourhood,
            "window": CalibratorWindow,
            "qc": CalibratorQc,
            "qq": CalibratorQq,
            "threshold": CalibratorThreshold,
            "sort": CalibratorSort,
            "altitude": CalibratorAltitude,
            "override": CalibratorOverride,
            "diagnoseWind": CalibratorDiagnoseWind,
            "diagnoseHumidity": CalibratorDiagnoseHumidity,
            "gaussian": CalibratorGaussian,
            "oi": CalibratorOi,
            "qnh": CalibratorQnh,
            "phase": CalibratorPhase,
            "windDirection": CalibratorWindDirection,
            "mask": CalibratorMask,
            "regression": CalibratorRegression,
            "cloud": CalibratorCloud,
            "zaga": CalibratorZaga,
            "bct": CalibratorBct,
            "kriging": CalibratorKriging,
            "coastal": CalibratorCoastal,
        }
        if name not in schemes:
            raise RuntimeError(
                f"Could not instantiate calibrator with name '{name}'")
        return schemes[name](variable, options)


class CalibratorAccumulate(Calibrator):
    """Accumulate along time (Calibrator/Accumulate.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        # acc[0] = 0; acc[t] = acc[t-1] + field[t]; missing propagates
        # forward (Accumulate.cpp:22-46)
        field = ofile.get_field(self.variable)
        out = np.zeros_like(field)
        if field.shape[0] > 1:
            tail = field[1:]
            acc = np.cumsum(np.where(np.isfinite(tail), tail, 0), axis=0)
            bad = np.cumsum(~np.isfinite(tail), axis=0) > 0
            out[1:] = np.where(bad, np.nan, acc)
        ofile.add_field(self.variable, out.astype(np.float32))


class CalibratorDeaccumulate(Calibrator):
    """Time-difference over a window (Calibrator/Deaccumulate.cpp:10-49):
    out[t] = acc[t] - acc[t - window], MV for t < window or when either
    endpoint is missing."""

    def calibrate(self, ofile, parameter_file=None):
        window = self.options.get("window", 1, int)
        field = ofile.get_field(self.variable)
        out = np.full_like(field, np.nan)
        if window <= 0:
            # acc[t] - acc[t-0]: zeros (NaN where the endpoint is missing)
            out[:] = field - field
        elif field.shape[0] > window:
            out[window:] = field[window:] - field[:-window]
        ofile.add_field(self.variable, out.astype(np.float32))


class CalibratorNeighbourhood(Calibrator):
    """Spatial smoothing (Calibrator/Neighbourhood.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        radius = self.options.get("radius", 3, int)
        stat = gridpp.get_statistic(self.options.get("stat", "mean"))
        field = ofile.get_field(self.variable)
        out = np.empty_like(field)
        for t in range(field.shape[0]):
            for e in range(field.shape[3]):
                out[t, :, :, e] = gridpp.neighbourhood(field[t, :, :, e],
                                                       radius, stat)
        ofile.add_field(self.variable, out)


class CalibratorWindow(Calibrator):
    """Temporal window statistic (Calibrator/Window.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        length = self.options.get("length", 3, int)
        stat = gridpp.get_statistic(self.options.get("stat", "mean"))
        before = self.options.get("before", False, bool)
        keep_missing = self.options.get("keepMissing", False, bool)
        field = ofile.get_field(self.variable)
        nt, ny, nx, ne = field.shape
        cases = np.transpose(field, (1, 2, 3, 0)).reshape(-1, nt)
        res = gridpp.window(cases, length, stat, before, keep_missing, False)
        out = np.transpose(res.reshape(ny, nx, ne, nt), (3, 0, 1, 2))
        ofile.add_field(self.variable, out.astype(np.float32))


class CalibratorQc(Calibrator):
    """Clamp to [min, max] (Calibrator/Qc.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        lo = self.options.get("min", -np.inf, float)
        hi = self.options.get("max", np.inf, float)
        field = ofile.get_field(self.variable)
        ofile.add_field(self.variable, np.clip(field, lo, hi))


class CalibratorThreshold(Calibrator):
    """Map threshold ranges to values (Calibrator/Threshold.cpp:26-58):
    first p with value < thresholds[p] (or == when equals[p]=1) selects
    values[p]; otherwise values[n]. len(values) == len(thresholds)+1."""

    def calibrate(self, ofile, parameter_file=None):
        thresholds = self.options.get_floats("thresholds")
        values = self.options.get_floats("values")
        equals = self.options.get_floats("equals")
        if not equals:
            equals = [0.0] * len(thresholds)
        if len(values) != len(thresholds) + 1:
            raise RuntimeError("Length of 'values' must be one longer "
                               "than the length of 'thresholds'")
        if len(equals) != len(thresholds):
            raise RuntimeError("Length of 'equals' must be the same as "
                               "the length of 'thresholds'")
        field = ofile.get_field(self.variable)
        out = np.full_like(field, values[len(thresholds)])
        assigned = np.zeros(field.shape, bool)
        for thr, val, eq in zip(thresholds, values, equals):
            hit = (field < thr) | ((field == thr) & (eq == 1))
            out = np.where(hit & ~assigned, val, out)
            assigned |= hit
        out = np.where(np.isfinite(field), out, np.nan)
        ofile.add_field(self.variable, out.astype(np.float32))


class CalibratorSort(Calibrator):
    """Sort ensemble members (Calibrator/Sort.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        field = ofile.get_field(self.variable)
        ofile.add_field(self.variable, np.sort(field, axis=-1))


class CalibratorAltitude(Calibrator):
    """Overwrite grid altitudes from the parameter file
    (Calibrator/Altitude.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        pass  # altitudes live on the Grid; no field change


class CalibratorOverride(Calibrator):
    """Override values near parameter points (Calibrator/Override.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        radius = self.options.get("radius", 0, int)
        points, params = parameter_file.to_points()
        field = ofile.get_field(self.variable)
        out = field.copy()
        for t in range(field.shape[0]):
            for e in range(field.shape[3]):
                out[t, :, :, e] = gridpp.doping_square(
                    ofile.grid, field[t, :, :, e], points,
                    params[:, 0], np.full(points.size(), radius, int))
        ofile.add_field(self.variable, out)


class CalibratorDiagnoseWind(Calibrator):
    """Wind speed/direction from x/y components
    (Calibrator/DiagnoseWind.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        xname = self.options.get("x", "x_wind_10m")
        yname = self.options.get("y", "y_wind_10m")
        compute = self.options.get("compute", "speed")
        x = ofile.get_field(xname)
        y = ofile.get_field(yname)
        if compute == "speed":
            out = gridpp.wind_speed(x.ravel(), y.ravel()).reshape(x.shape)
        else:
            out = gridpp.wind_direction(x.ravel(),
                                        y.ravel()).reshape(x.shape)
        ofile.add_field(self.variable, out.astype(np.float32))


class CalibratorDiagnoseHumidity(Calibrator):
    """Dewpoint/RH/wetbulb diagnosis (Calibrator/DiagnoseHumidity.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        compute = self.options.get("compute", "dewpoint")
        temp = ofile.get_field(self.options.get("temperature",
                                                "air_temperature_2m"))
        if compute == "dewpoint":
            rh = ofile.get_field(self.options.get("rh",
                                                  "relative_humidity_2m"))
            out = gridpp.dewpoint(temp.ravel(), rh.ravel())
        elif compute == "rh":
            td = ofile.get_field(self.options.get("dewpoint",
                                                  "dew_point_temperature_2m"))
            out = gridpp.relative_humidity(temp.ravel(), td.ravel())
        else:
            rh = ofile.get_field(self.options.get("rh",
                                                  "relative_humidity_2m"))
            p = ofile.get_field(self.options.get("pressure",
                                                 "surface_air_pressure"))
            out = gridpp.wetbulb(temp.ravel(), p.ravel(), rh.ravel())
        ofile.add_field(self.variable, out.reshape(temp.shape).astype(
            np.float32))


class CalibratorGaussian(Calibrator):
    """Gaussian spread calibration: transform members to mean + scaled
    anomalies (a simplified Calibrator/Gaussian.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        field = ofile.get_field(self.variable)
        if parameter_file is None:
            return
        params = parameter_file.parameters_at_time(0)
        a = params[0] if len(params) > 0 else 0.0
        b = params[1] if len(params) > 1 else 1.0
        mean = np.nanmean(field, axis=-1, keepdims=True)
        out = mean + a + b * (field - mean)
        ofile.add_field(self.variable, out.astype(np.float32))


class CalibratorQq(Calibrator):
    """Quantile mapping using curve parameters (Calibrator/Qq.cpp).

    The parameter file holds alternating (obs, fcst) pairs.
    """

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        params = parameter_file.parameters_at_time(0)
        pairs = np.asarray(params, np.float32)
        ref = pairs[0::2]
        fcst = pairs[1::2]
        order = np.argsort(fcst)
        field = ofile.get_field(self.variable)
        out = gridpp.apply_curve(field.reshape(-1), ref[order], fcst[order],
                                 gridpp.OneToOne, gridpp.OneToOne)
        ofile.add_field(self.variable,
                        out.reshape(field.shape).astype(np.float32))


class CalibratorQnh(Calibrator):
    def calibrate(self, ofile, parameter_file=None):
        p = ofile.get_field(self.options.get("pressure",
                                             "surface_air_pressure"))
        elevs = np.asarray(ofile.grid.get_elevs(), np.float32)
        nt, ny, nx, ne = p.shape
        alt = np.broadcast_to(elevs[None, :, :, None], p.shape)
        out = gridpp.qnh(p.ravel(), alt.ravel().astype(np.float32))
        ofile.add_field(self.variable, out.reshape(p.shape).astype(
            np.float32))


class CalibratorPhase(Calibrator):
    """Precipitation phase from temperature thresholds
    (Calibrator/Phase.cpp): 0=none, 1=rain, 2=sleet, 3=snow."""

    def calibrate(self, ofile, parameter_file=None):
        snow = self.options.get("snowThreshold", 273.15, float)
        rain = self.options.get("rainThreshold", 274.15, float)
        temp = ofile.get_field(self.options.get("temperature",
                                                "air_temperature_2m"))
        precip = ofile.get_field(self.options.get("precipitation",
                                                  "precipitation_amount"))
        phase = np.where(precip <= 0, 0.0,
                         np.where(temp <= snow, 3.0,
                                  np.where(temp <= rain, 2.0, 1.0)))
        phase = np.where(np.isfinite(temp) & np.isfinite(precip), phase,
                         np.nan)
        ofile.add_field(self.variable, phase.astype(np.float32))


class CalibratorWindDirection(Calibrator):
    """Scale wind speed by a direction-dependent factor
    (Calibrator/WindDirection.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        field = ofile.get_field(self.variable)
        direction = ofile.get_field(self.options.get("directionVariable",
                                                     "wind_direction_10m"))
        params = np.asarray(parameter_file.parameters_at_time(0), np.float32)
        # params: factors at evenly spaced directions 0..360
        n = len(params)
        dirs = np.linspace(0, 360, n)
        factor = np.interp(direction.ravel(), dirs, params).reshape(
            field.shape)
        ofile.add_field(self.variable, (field * factor).astype(np.float32))


class CalibratorMask(Calibrator):
    """Mask out values near/far from parameter points
    (Calibrator/Mask.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        keep = self.options.get("keep", True, bool)
        points, params = parameter_file.to_points()
        field = ofile.get_field(self.variable)
        radii = params[:, 0] if params.shape[1] else np.full(points.size(),
                                                            10000.0)
        # keep=1: remove gridpoints OUTSIDE every radius; keep=0: remove
        # gridpoints INSIDE any radius (Mask.cpp:62-64 remove = keep !=
        # withinRadius)
        out = field.copy()
        for t in range(field.shape[0]):
            for e in range(field.shape[3]):
                out[t, :, :, e] = gridpp.fill(ofile.grid, field[t, :, :, e],
                                              points, radii, MV, keep)
        ofile.add_field(self.variable, out)


class CalibratorRegression(Calibrator):
    """Linear regression correction y = sum(p_i * x^i)
    (Calibrator/Regression.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        params = np.asarray(parameter_file.parameters_at_time(0), np.float64)
        if params.size == 0:
            # Regression.cpp errors when the parameter file carries no
            # coefficients (Testing/CalibratorRegression.cpp invalid)
            raise RuntimeError("Regression parameter file has no "
                               "coefficients")
        field = ofile.get_field(self.variable)
        out = np.zeros_like(field, np.float64)
        for i, p in enumerate(params):
            out += p * np.power(field.astype(np.float64), i)
        out = np.where(np.isfinite(field), out, np.nan)
        ofile.add_field(self.variable, out.astype(np.float32))


# The operational OI calibrator lives in its own module (the reference's
# Calibrator/Oi.cpp is 1218 lines with ~30 options; see
# client/oi_calibrator.py for the full ensemble/single-member
# implementation with transforms, bias/delta state and screening).
from .oi_calibrator import CalibratorOi  # noqa: E402


class CalibratorCloud(Calibrator):
    """Ensure a minimum cloud cover where precipitation is present
    (Calibrator/Cloud.cpp)."""

    def calibrate(self, ofile, parameter_file=None):
        precip_var = self.options.get_required("precipVariable")
        value = self.options.get("value", 1.0, float)
        precip = ofile.get_field(precip_var)
        cloud = ofile.get_field(self.variable)
        bump = np.isfinite(precip) & np.isfinite(cloud) & (precip > 0) & \
            (cloud < value)
        ofile.add_field(self.variable,
                        np.where(bump, value, cloud).astype(np.float32))


def _grid_params(parameter_file, ofile, t):
    """(Y, X, P) parameter field for time t (nearest-location lookup)."""
    lats = np.asarray(ofile.grid.get_lats(), np.float64)
    lons = np.asarray(ofile.grid.get_lons(), np.float64)
    rows = parameter_file.params_for_locations(t, lats, lons)
    return rows.reshape(lats.shape + (rows.shape[-1],))


class CalibratorZaga(Calibrator):
    """Zero-adjusted gamma precipitation calibration
    (Calibrator/Zaga.cpp). The ensemble at each cell is replaced by the
    quantiles (e+0.5)/E of a ZAGA distribution whose parameters are
    regressions on the (neighbourhood/time-window aggregated) ensemble
    mean and the fraction of members <= fracThreshold; member order is
    restored by rank shuffling. In POP mode, writes exceedance
    probability and optional quantile fields instead."""

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        frac_threshold = self.options.get("fracThreshold", 0.5, float)
        nsize = self.options.get("neighbourhoodSize", 0, int)
        max_ens_mean = self.options.get("maxEnsMean", 100.0, float)
        six_h = self.options.get("6h", False, bool)
        pop_var = self.options.get("popVariable", "")
        pop_threshold = self.options.get("popThreshold", 0.5, float)
        quantile_vars = []  # (quantile, output variable) extras in POP mode
        for key, var_key in (("precipLowQuantile", "lowVariable"),
                             ("precipMiddleQuantile", "middleVariable"),
                             ("precipHighQuantile", "highVariable")):
            q = self.options.get(key, np.nan, float)
            if np.isfinite(q):
                quantile_vars.append((q, self.options.get_required(var_key)))

        field = ofile.get_field(self.variable)  # (T, Y, X, E)
        nt, ny, nx, ne = field.shape
        start_time, window = (5, 6) if six_h else (0, 1)
        out = field.copy()
        pop_out = np.full_like(field, np.nan) if pop_var else None
        q_outs = {var: np.full_like(field, np.nan)
                  for _, var in quantile_vars}

        for t in range(nt):
            params = _grid_params(parameter_file, ofile, t)  # (Y, X, 8)
            if pop_var and t < start_time:
                continue  # no 6h accumulation possible yet (Zaga.cpp:105-109)
            # Time-window accumulation per member (Zaga.cpp:121-133)
            lo = t - window + 1
            if lo < 0:
                total = np.full((ny, nx, ne), np.nan, np.float32)
            else:
                total = np.sum(field[lo:t + 1], axis=0)
            # Neighbourhood-ensemble aggregation (Zaga.cpp:118-144)
            if nsize > 0:
                stack = []
                for dy in range(-nsize, nsize + 1):
                    for dx in range(-nsize, nsize + 1):
                        ys = np.clip(np.arange(ny) + dy, 0, ny - 1)
                        xs = np.clip(np.arange(nx) + dx, 0, nx - 1)
                        # mimic window-intersection: mark clipped cells nan
                        sl = total[ys][:, xs]
                        oob = ((np.arange(ny) + dy < 0) |
                               (np.arange(ny) + dy >= ny))[:, None] | \
                              ((np.arange(nx) + dx < 0) |
                               (np.arange(nx) + dx >= nx))[None, :]
                        stack.append(np.where(oob[..., None], np.nan, sl))
                pool = np.stack(stack, axis=-1).reshape(ny, nx, -1)
                # out-of-domain slots are excluded; any invalid member
                # in-domain invalidates the cell (reference MV cascade)
                in_domain = np.isfinite(pool).sum(axis=-1)
                expected = np.zeros((ny, nx), int)
                for dy in range(-nsize, nsize + 1):
                    for dx in range(-nsize, nsize + 1):
                        iny = (np.arange(ny) + dy >= 0) & \
                              (np.arange(ny) + dy < ny)
                        inx = (np.arange(nx) + dx >= 0) & \
                              (np.arange(nx) + dx < nx)
                        expected += iny[:, None] * inx[None, :] * ne
                all_valid = in_domain == expected
                ens_mean = np.where(all_valid, np.nansum(pool, -1) /
                                    np.maximum(in_domain, 1), np.nan)
                ens_frac = np.where(
                    all_valid,
                    np.nansum(pool <= frac_threshold, -1) /
                    np.maximum(in_domain, 1), np.nan)
            else:
                all_valid = np.isfinite(total).all(axis=-1)
                ens_mean = np.where(all_valid, total.mean(-1), np.nan)
                ens_frac = np.where(all_valid,
                                    (total <= frac_threshold).mean(-1),
                                    np.nan)
            ens_mean = np.minimum(ens_mean, max_ens_mean)
            params_ok = np.isfinite(params).all(axis=-1)
            valid = (np.isfinite(ens_mean) & (ens_mean >= 0) &
                     np.isfinite(ens_frac) & (ens_frac >= 0) &
                     (ens_frac <= 1) & params_ok)
            p0, shape, scale = _zaga_params(ens_mean, ens_frac, params)
            valid &= np.isfinite(p0) & (shape > 0) & (scale > 0)

            if pop_var:
                from scipy.stats import gamma as _gamma
                cont = _gamma.cdf(pop_threshold, np.maximum(shape, 1e-12),
                                  scale=np.maximum(scale, 1e-12))
                cdf = p0 + (1 - p0) * cont
                pop = np.where(valid, 1 - cdf, np.nan)
                pop_out[t] = pop[..., None]
                for q, var in quantile_vars:
                    vals = _zaga_inv_cdf(q, p0, shape, scale, valid)
                    q_outs[var][t] = vals[..., None]
            else:
                qs = (np.arange(ne) + 0.5) / ne
                cal = _zaga_inv_cdf(qs[None, None, :], p0[..., None],
                                    shape[..., None], scale[..., None],
                                    valid[..., None])
                cal_ok = np.isfinite(cal).all(axis=-1)
                shuffled = Calibrator.shuffle(field[t], cal)
                use = (valid & cal_ok)[..., None]
                out[t] = np.where(use, shuffled, field[t])

        if pop_var:
            ofile.add_field(pop_var, pop_out.astype(np.float32))
            for _, var in quantile_vars:
                ofile.add_field(var, q_outs[var].astype(np.float32))
        else:
            ofile.add_field(self.variable, out.astype(np.float32))


def _zaga_params(ens_mean, ens_frac, params):
    """ZAGA (p0, gamma shape, gamma scale) from regression parameters
    [mua mub sa sb a b c d] (Zaga.cpp:245-300, 385-399)."""
    with np.errstate(all="ignore"):
        mua, mub = params[..., 0], params[..., 1]
        sa, sb = params[..., 2], params[..., 3]
        a, b = params[..., 4], params[..., 5]
        c, d = params[..., 6], params[..., 7]
        cube = np.cbrt(np.maximum(ens_mean, 0))
        mu = np.exp(mua + mub * cube)
        sigma = np.exp(sa + sb * ens_mean)
        logit = a + b * ens_mean + c * ens_frac + d * cube
        p0 = np.exp(logit) / (np.exp(logit) + 1)
        shape = 1 / (sigma * sigma)
        scale = sigma * sigma * mu
    return p0, shape, scale


def _zaga_inv_cdf(q, p0, shape, scale, valid):
    """Quantile of the zero-adjusted gamma (Zaga.cpp:243-302)."""
    from scipy.stats import gamma as _gamma
    with np.errstate(all="ignore"):
        qc = (q - p0) / (1 - p0)
        vals = _gamma.ppf(np.clip(qc, 0, 1 - 1e-9),
                          np.maximum(shape, 1e-12),
                          scale=np.maximum(scale, 1e-12))
        vals = np.where(q < p0, 0.0, vals)
    return np.where(valid & np.isfinite(vals), vals, np.nan)


class CalibratorBct(Calibrator):
    """Box-Cox t-distribution ensemble calibration (Calibrator/Bct.cpp):
    mean = a + b*ensmean, sigma = exp(c + d*ensstd^(1/3)),
    nu = e + f*ensmean, tau = exp(g); members become the (e+0.5)/E
    quantiles, rank-shuffled back to the raw member order."""

    MAX_ENS_MEAN = 100.0

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        from scipy.stats import t as _t
        field = ofile.get_field(self.variable)
        nt, ny, nx, ne = field.shape
        out = field.copy()
        for t in range(nt):
            params = _grid_params(parameter_file, ofile, t)  # (Y, X, 7)
            ens = field[t]
            all_valid = np.isfinite(ens).all(axis=-1)
            ens_mean = np.where(all_valid, ens.mean(-1), np.nan)
            ens_std = np.where(all_valid, ens.std(-1), np.nan)
            valid = (all_valid & (ens_mean >= 0) & (ens_std >= 0) &
                     np.isfinite(params).all(axis=-1))
            ens_mean = np.minimum(ens_mean, self.MAX_ENS_MEAN)
            with np.errstate(all="ignore"):
                a, b = params[..., 0], params[..., 1]
                c, d = params[..., 2], params[..., 3]
                e_, f = params[..., 4], params[..., 5]
                g = np.minimum(params[..., 6], 10.0)  # Bct.cpp:162-168
                mu = a + b * ens_mean
                sigma = np.exp(c + d * np.cbrt(np.maximum(ens_std, 0)))
                nu = e_ + f * ens_mean
                tau = np.exp(g)
                qs = (np.arange(ne) + 0.5) / ne  # (E,)
                trunc = _t.cdf(1.0 / (sigma * np.abs(nu)), tau)[..., None]
                qz = np.where(nu[..., None] <= 0, qs * trunc,
                              1 - (1 - qs) * trunc)
                z = _t.ppf(qz, tau[..., None])
                base = 1 + sigma[..., None] * nu[..., None] * z
                cal = np.where(
                    nu[..., None] != 0,
                    mu[..., None] * np.power(np.maximum(base, 0),
                                             1.0 / nu[..., None]),
                    mu[..., None] * np.exp(sigma[..., None] * z))
                cal = np.where(base > 0, cal,
                               np.where(nu[..., None] != 0, np.nan, cal))
            cal_ok = np.isfinite(cal).all(axis=-1)
            shuffled = Calibrator.shuffle(ens, cal)
            use = (valid & cal_ok)[..., None]
            out[t] = np.where(use, shuffled, ens)
        ofile.add_field(self.variable, out.astype(np.float32))


class CalibratorKriging(Calibrator):
    """Spread station biases in space by kriging (Calibrator/Kriging.cpp).

    weights = K^-1 S per gridpoint (dense batched matmul — the data-parallel
    form of the reference's per-gridpoint sparse loops); bias field =
    weights . station_biases, applied by +,-,*,/."""

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        if not parameter_file.is_location_dependent():
            raise RuntimeError(
                "Kriging requires a parameter file with spatial information")
        efold = self.options.get("efoldDist", 30000.0, float)
        radius = self.options.get("radius", 30000.0, float)
        max_elev_diff = self.options.get("maxElevDiff", np.nan, float)
        ktype = self.options.get("type", "cressman")
        operator = self.options.get("operator", "add")
        cross_validate = self.options.get("crossValidate", False, bool)
        aux_var = self.options.get("auxVariable", "")
        window = self.options.get("window", 0, int)
        if efold < 0 or radius < 0:
            raise RuntimeError("efoldDist and radius must be >= 0")
        if ktype not in ("cressman", "barnes"):
            raise RuntimeError("Kriging 'type' not recognized")
        if operator not in ("add", "subtract", "multiply", "divide"):
            raise RuntimeError("Kriging 'operator' not recognized")
        if aux_var:
            rng = self.options.get_floats("range")
            if len(rng) != 2 or rng[0] > rng[1]:
                raise RuntimeError(
                    "Kriging 'range' must be of the form lower,upper")

        points, _ = parameter_file.to_points()
        slats = points.get_lats()
        slons = points.get_lons()
        selevs = np.nan_to_num(np.asarray(points.get_elevs(), np.float64))
        n = points.size()

        def covar(lat1, lon1, elev1, lat2, lon2, elev2):
            """calcCovar (Kriging.cpp:392-426) on broadcast arrays."""
            d = _equirect_distance(lat1, lon1, lat2, lon2)
            vd = np.abs(elev1 - elev2)
            if ktype == "cressman":
                w = np.where(d > efold, 0.0,
                             (efold ** 2 - d ** 2) / (efold ** 2 + d ** 2))
                if np.isfinite(max_elev_diff):
                    vw = np.where(vd > max_elev_diff, 0.0,
                                  (max_elev_diff ** 2 - vd ** 2) /
                                  (max_elev_diff ** 2 + vd ** 2))
                    w = w * vw
            else:
                w = np.exp(-d * d / (2 * efold * efold))
                if np.isfinite(max_elev_diff):
                    w = w * np.exp(-vd * vd /
                                   (2 * max_elev_diff * max_elev_diff))
            cut = d >= radius
            if np.isfinite(max_elev_diff):
                cut |= vd >= max_elev_diff
            return np.where(cut, 0.0, w)

        # Station-station kernel, conditioning factor on off-diagonals
        # (Kriging.cpp:200-210)
        k = covar(slats[:, None], slons[:, None], selevs[:, None],
                  slats[None, :], slons[None, :], selevs[None, :])
        k = k * (0.414 / 0.5)
        np.fill_diagonal(k, 1.0)
        kinv = np.linalg.inv(k)

        glats = np.asarray(ofile.grid.get_lats(), np.float64)
        glons = np.asarray(ofile.grid.get_lons(), np.float64)
        gelevs = np.nan_to_num(np.asarray(ofile.grid.get_elevs(),
                                          np.float64))
        ny, nx = glats.shape
        # Gridpoint-to-station covariances: (Y*X, N) dense
        s = covar(glats.reshape(-1, 1), glons.reshape(-1, 1),
                  gelevs.reshape(-1, 1), slats[None, :], slons[None, :],
                  selevs[None, :])
        if cross_validate:
            # Zero the strongest-covariance station per gridpoint and
            # fold its removal into the solve (Kriging.cpp:295-318).
            imax = np.argmax(s, axis=1)
            s[np.arange(s.shape[0]), imax] = 0.0
            weights = np.empty_like(s)
            for st in np.unique(imax):
                kcv = k.copy()
                kcv[st, :] = 0
                kcv[:, st] = 0
                kcv[st, st] = 1
                rows = imax == st
                weights[rows] = s[rows] @ np.linalg.inv(kcv)
                weights[rows, st] = 0
        else:
            weights = s @ kinv  # symmetric K: (K^-1 S)^T = S K^-1

        field = ofile.get_field(self.variable)
        nt = field.shape[0]
        aux_weights = None
        if aux_var:
            aux = ofile.get_field(aux_var)  # (T, Y, X, E)
            lo_thr, hi_thr = rng
            aux_weights = np.empty_like(aux)
            for t in range(nt):
                lo_t, hi_t = max(t - window, 0), min(nt - 1, t + window)
                win = aux[lo_t:hi_t + 1]
                in_range = ((win >= lo_thr) & (win <= hi_thr) &
                            np.isfinite(win)).sum(axis=0)
                num_valid = np.isfinite(win).sum(axis=0)
                aux_weights[t] = np.where(num_valid == 0, 1.0,
                                          in_range /
                                          np.maximum(num_valid, 1))

        out = field.copy()
        for t in range(nt):
            rows = parameter_file.params_for_locations(t, slats, slons)
            bias = rows[:, 0].astype(np.float64)
            if operator in ("multiply", "divide"):
                bias = bias - 1  # fluctuations around 1 (Kriging.cpp:270-276)
            covered = (s > 0).any(axis=1).reshape(ny, nx)
            final = (weights @ bias).reshape(ny, nx)
            final = np.where(np.isfinite(bias).all(), final, np.nan)
            if operator == "multiply":
                final = final + 1
            elif operator == "divide":
                final = final - 1
            fb = final[..., None]
            if aux_weights is not None:
                w = aux_weights[t]
                if operator in ("add", "subtract"):
                    fb = fb * w
                else:
                    fb = np.power(fb, w)
            apply = np.isfinite(fb) & covered[..., None]
            if operator == "add":
                res = field[t] + fb
            elif operator == "subtract":
                res = field[t] - fb
            elif operator == "multiply":
                res = field[t] * fb
            else:
                res = field[t] / fb
            out[t] = np.where(apply, res, field[t])
        ofile.add_field(self.variable, out.astype(np.float32))


def _equirect_distance(lat1, lon1, lat2, lon2):
    """Equirectangular-approximation distance in meters
    (client Util::getDistance approx=true)."""
    r = 6.37e6
    lat1r, lat2r = np.deg2rad(lat1), np.deg2rad(lat2)
    dlat = lat1r - lat2r
    dlon = np.deg2rad(lon1 - lon2) * np.cos((lat1r + lat2r) / 2)
    return r * np.hypot(dlat, dlon)


class CalibratorCoastal(Calibrator):
    """Regression blend of land and sea forecasts (Calibrator/Coastal.cpp):
    value = a + b*base + c*gradient, where gradient is the field range
    between the min/max land-area-fraction cells in a search window."""

    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            return
        if not parameter_file.is_location_dependent():
            raise RuntimeError("Parameter file must be spatial")
        radius = self.options.get("searchRadius", 3, int)
        min_laf_diff = self.options.get("minLafDiff", 0.1, float)
        use_nn = self.options.get("useNN", False, bool)
        laf = np.asarray(ofile.grid.get_lafs(), np.float64)
        ny, nx = laf.shape

        # Window argmin/argmax of LAF per cell, scanning the same
        # neighbour order as the reference's ii/jj loops (ties -> first).
        min_laf = np.full((ny, nx), 2.0)
        max_laf = np.full((ny, nx), -1.0)
        min_iy = np.zeros((ny, nx), int)
        min_ix = np.zeros((ny, nx), int)
        max_iy = np.zeros((ny, nx), int)
        max_ix = np.zeros((ny, nx), int)
        yy = np.arange(ny)[:, None]
        xx = np.arange(nx)[None, :]
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                sy = np.clip(yy + dy, 0, ny - 1)
                sx = np.clip(xx + dx, 0, nx - 1)
                inside = ((yy + dy >= 0) & (yy + dy < ny) &
                          (xx + dx >= 0) & (xx + dx < nx))
                cand = np.where(inside, laf[sy, sx], np.nan)
                lower = inside & (cand < min_laf)
                upper = inside & (cand > max_laf)
                min_laf = np.where(lower, cand, min_laf)
                min_iy = np.where(lower, sy, min_iy)
                min_ix = np.where(lower, sx, min_ix)
                max_laf = np.where(upper, cand, max_laf)
                max_iy = np.where(upper, sy, max_iy)
                max_ix = np.where(upper, sx, max_ix)

        field = ofile.get_field(self.variable)
        nt = field.shape[0]
        out = field.copy()
        glats = np.asarray(ofile.grid.get_lats(), np.float64)
        glons = np.asarray(ofile.grid.get_lons(), np.float64)
        for t in range(nt):
            params = _grid_params(parameter_file, ofile, t)  # (Y, X, >=3)
            a = params[..., 0, None]
            b = params[..., 1, None]
            c = params[..., 2, None]
            lower_value = field[t][min_iy, min_ix]  # (Y, X, E)
            upper_value = field[t][max_iy, max_ix]
            use_range = ((max_laf - min_laf) > min_laf_diff)[..., None]
            grad = np.where(
                use_range & np.isfinite(lower_value) &
                np.isfinite(upper_value),
                (upper_value - lower_value) /
                np.maximum((max_laf - min_laf)[..., None], 1e-12), 0.0)
            base = field[t] if use_nn else lower_value
            out[t] = a + b * base + c * grad
        ofile.add_field(self.variable, out.astype(np.float32))
