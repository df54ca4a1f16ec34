"""Shared helpers for the API layer: array coercion and validation.

The reference maps std::invalid_argument to Python ValueError via SWIG
(reference swig/gridpp.i:21-40); API functions here raise ValueError with
equivalent messages so the reference's invalid-argument test sweeps port
unchanged.
"""
from __future__ import annotations

import numpy as np

from ..core.grid import Grid
from ..core.points import Points


def asarray_f32(x, name="values"):
    try:
        arr = np.asarray(x, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"Could not convert {name} to a float array: {e}")
    return arr


def require_ndim(arr, ndim, name="values"):
    if arr.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}D")
    return arr


def check_grid_compatible(grid: Grid, values: np.ndarray, tdim: bool = False):
    """compatible_size(Grid, vec2/vec3) (util.cpp:434-444)."""
    shape = values.shape[-2:]
    gy, gx = grid.size()
    if values.size == 0:
        return
    if shape != (gy, gx):
        raise ValueError("Grid size is not the same as values")


def check_points_compatible(points: Points, values: np.ndarray):
    n = values.shape[-1]
    if points.size() != n:
        raise ValueError("Points size is not the same as values")


def check_same_shape(a, b, msg):
    if np.shape(a) != np.shape(b):
        raise ValueError(msg)


def to_numpy(x):
    return np.asarray(x)


_CPU_DEVICE = None


def cpu_device():
    """THIS process's XLA:CPU device (always present alongside any
    accelerator). Must be process-local: in a multi-host job
    jax.devices() lists other hosts' devices too, which are not
    addressable here."""
    global _CPU_DEVICE
    if _CPU_DEVICE is None:
        import jax
        _CPU_DEVICE = jax.local_devices(backend="cpu")[0]
    return _CPU_DEVICE


def on_host() -> bool:
    """True when execution is pinned to the host CPU backend (inside a
    pin_host-wrapped API call, or when CPU is the platform anyway)."""
    import jax
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev.platform == "cpu"
    return jax.default_backend() == "cpu"


def pin_host(fn):
    """Pin a parity-API function's XLA execution to the host CPU backend.

    The numpy-in/numpy-out API contract is host memory, like the reference's
    SWIG bindings; its ops therefore compile and run on XLA:CPU. Device
    entry points (gridpp_tpu.ops, Pipeline, gridpp_tpu.parallel) call the
    same jitted functions with device-resident arrays and compile for the
    accelerator - the jit cache keys on placement, so both coexist.
    The pin needs the CPU backend: JAX_PLATFORMS must not exclude "cpu".
    """
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import jax
        with jax.default_device(cpu_device()):
            return fn(*args, **kwargs)

    wrapper.__wrapped_host_pin__ = True
    return wrapper
