"""gridpp_tpu: a gridded post-processing engine on JAX/XLA.

A from-scratch JAX/XLA implementation of the capability surface of
metno/gridpp (downscaling, neighbourhood statistics, calibration, optimal
interpolation): spatial search is a one-time host precompute emitting
gather maps; all apply-time compute is dense batched XLA programs; large
grids shard over a device mesh with halo exchange.

The public namespace mirrors gridpp's Python bindings (same function names,
argument orders, enums, and ValueError behaviour) so existing gridpp user
code and tests port near-verbatim.
"""
from .constants import *  # noqa: F401,F403  (enums, constants, MV, version)
from .constants import __version__

from .core.grid import Grid  # noqa: F401
from .core.kdtree import KDTree  # noqa: F401
from .core.point import Point  # noqa: F401
from .core.points import Points  # noqa: F401

from .api.utils import (  # noqa: F401
    calc_even_quantiles, calc_quantile, calc_statistic, compatible_size,
    convert_coordinates, get_lower_index, get_upper_index, init_ivec2,
    init_ivec3, init_vec2, init_vec3, interpolate, is_valid, is_valid_lat,
    is_valid_lon, num_missing_values, point_in_rectangle,
)
from .api.downscaling import bilinear, downscaling, nearest  # noqa: F401
from .structure import (  # noqa: F401
    BarnesStructure, CressmanStructure, CrossValidation, LinearStructure,
    MultipleStructure, PowerlawStructure, SoarStructure, StructureFunction,
    ToarStructure,
)
from .api.oi import (  # noqa: F401
    optimal_interpolation, optimal_interpolation_full,
)
from .api.oi_ensi import optimal_interpolation_ensi  # noqa: F401
from .api.oi_ensi_multi import (  # noqa: F401
    optimal_interpolation_ensi_multi_ebe,
    optimal_interpolation_ensi_multi_ebesc,
    optimal_interpolation_ensi_multi_utem,
)
from .api.curves import (  # noqa: F401
    apply_curve, calc_score, get_optimal_threshold, metric_optimizer_curve,
    monotonize_curve, quantile_mapping_curve,
)
from .api.transform import (  # noqa: F401
    BoxCox, Gamma, Identity, Log, StartedBoxCox, Transform,
)
from .api.diagnostics import (  # noqa: F401
    dewpoint, gamma_inv, pressure, qnh, relative_humidity,
    sea_level_pressure, wetbulb, wind_direction, wind_speed,
)
from .api.gradients import (  # noqa: F401
    calc_gradient, full_gradient, full_gradient_debug, simple_gradient,
)
from .api.window_api import window  # noqa: F401
from .api.gridding import count, distance, gridding, gridding_nearest  # noqa: F401
from .api.fill import doping_circle, doping_square, fill, fill_missing  # noqa: F401
from .api.masking import (  # noqa: F401
    downscale_probability, mask_threshold_downscale_consensus,
    mask_threshold_downscale_quantile,
)
from .api.search import neighbourhood_search, smart, staticcorr_points  # noqa: F401
from .api.ldc import local_distribution_correction  # noqa: F401
from .api.pipeline import (  # noqa: F401
    EnsiPipeline, MultiEnsiPipeline, Pipeline,
)
from .api.verif import (  # noqa: F401
    neighbourhood_score, test_array, test_ivec2_output, test_ivec3_output,
    test_ivec_input, test_ivec_output, test_not_implemented_exception,
    test_vec2_argout, test_vec2_input, test_vec2_output, test_vec3_input,
    test_vec3_output, test_vec_argout, test_vec_input, test_vec_output,
)
from .api.neighbourhood import (  # noqa: F401
    get_neighbourhood_thresholds, neighbourhood, neighbourhood_brute_force,
    neighbourhood_ens, neighbourhood_quantile, neighbourhood_quantile_ens,
    neighbourhood_quantile_ens_fast, neighbourhood_quantile_fast,
)

# ---- Host execution pinning ------------------------------------------
# The parity (numpy-in/numpy-out) API executes on the host XLA:CPU
# backend; GPU serving goes through the device entry points
# (gridpp_tpu.ops, Pipeline, gridpp_tpu.parallel), which run the same
# jitted ops on accelerator-resident arrays. See api._common.pin_host.
import types as _types

from .api._common import pin_host as _pin_host

for _name, _obj in list(globals().items()):
    if (isinstance(_obj, _types.FunctionType)
            and not _name.startswith("_")
            and _obj.__module__.startswith("gridpp_tpu.api")):
        globals()[_name] = _pin_host(_obj)
del _name, _obj


# SWIG-style static-method aliases kept for parity with the bindings
KDTree_calc_distance = KDTree.calc_distance
KDTree_calc_distance_fast = KDTree.calc_distance_fast
KDTree_calc_straight_distance = KDTree.calc_straight_distance
KDTree_deg2rad = KDTree.deg2rad
KDTree_rad2deg = KDTree.rad2deg


def set_omp_threads(num):  # parity no-op: XLA manages threading
    pass


def get_omp_threads():
    return 0


def initialize_omp():
    pass


_debug_level = 0


def set_debug_level(level):
    global _debug_level
    _debug_level = int(level)


def get_debug_level():
    return _debug_level


def clock():
    import time
    return time.time()


def debug(message):
    """Print a debug message (util.cpp:226-228)."""
    print(message)


def warning(message):
    """Print a warning message (util.cpp:230-232)."""
    print(f"Warning: {message}")


def error(message):
    """Print and raise an error (util.cpp:234-245)."""
    print(f"Error: {message}")
    raise RuntimeError(message)


def future_deprecation_warning(function, other=""):
    """Deprecation notice (util.cpp:246-252)."""
    msg = f"Future deprecation warning: {function} will be deprecated"
    if other:
        msg += f", use {other} instead."
    else:
        msg += "."
    print(msg)
