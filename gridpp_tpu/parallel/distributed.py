"""Multi-host distributed execution.

The reference is single-process (OpenMP only, gridpp.cpp:45-68); this
module is the multi-host layer SURVEY.md section 2d/7.7 calls for:

- `initialize`:   jax.distributed bring-up (one process per host), driven
                  by arguments or GRIDPP_* environment variables. No-op
                  for single-process runs.
- `global_mesh`:  a ('y', 'x') mesh over every device in the job. Hosts
                  split the 'y' axis, so halo exchange between the tiles
                  of one host stays on its own links (NVLink) and only
                  the host-boundary strip crosses the network;
                  observation vectors are replicated (they are KBs
                  against the grid's GBs).
- `global_field`: assemble a globally sharded jax.Array from each host's
                  local block of the grid (hosts never materialize the
                  full field - the point of going multi-host).
- `distributed_step`: the north-star pipeline (neighbourhood smooth +
                  deterministic OI) as one shard_map program over the
                  global mesh: halo exchange for the stencil, replicated
                  obs for the embarrassingly-parallel local OI solves.

Simulated multi-host runs (N processes on one machine, CPU backend) are
exercised by tools/scaling_multihost.py and tests/test_distributed.py.
"""
from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import neighbourhood as nops
from ..ops.oi import oi_block_dense
from .halo import halo_exchange_2d

__all__ = [
    "initialize", "is_distributed", "global_mesh", "global_field",
    "replicate", "make_distributed_step", "gather_to_host",
    "local_block_slices",
]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Bring up jax.distributed for a multi-host job.

    Arguments fall back to GRIDPP_COORDINATOR / GRIDPP_NUM_PROCESSES /
    GRIDPP_PROCESS_ID, then to JAX's own cluster autodetection. Returns
    True when a multi-process runtime was initialized. Safe to call twice
    and in single-process runs (returns False).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "GRIDPP_COORDINATOR")
    if num_processes is None and "GRIDPP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["GRIDPP_NUM_PROCESSES"])
    if process_id is None and "GRIDPP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["GRIDPP_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    # No jax.* queries before this point: jax.distributed.initialize must
    # run before anything touches the XLA backend
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True
    return jax.process_count() > 1


_initialized = False


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_mesh(axis_names=("y", "x"), host_shape=None) -> Mesh:
    """('y', 'x') mesh over all devices of the job.

    host_shape=(hy, hx) lays the hosts out as a 2-D host grid in
    process-major order: host p sits at row p // hx, column p % hx, and
    its local devices line up along 'x' inside that column block. The
    default (hy, hx) = (n_hosts, 1) splits only 'y' between hosts —
    halo traffic between a host's own tiles stays on its own links and
    only host-boundary strips cross the network; a 2-D host grid
    additionally exercises corner halo exchange and both-axis host
    boundaries (a layout for squarish domains). Single-host jobs
    fall back to the squarest local mesh.
    """
    devices = jax.devices()
    n_hosts = jax.process_count()
    if n_hosts > 1:
        per_host = len(devices) // n_hosts
        if host_shape is None:
            host_shape = (n_hosts, 1)
        hy, hx = int(host_shape[0]), int(host_shape[1])
        if hy * hx != n_hosts:
            raise ValueError(
                f"host_shape {host_shape} does not cover {n_hosts} hosts")
        arr = np.empty((hy, hx * per_host), dtype=object)
        for d in devices:
            r, c = divmod(d.process_index, hx)
            arr[r, c * per_host + _local_rank(d, devices)] = d
        return Mesh(arr, axis_names)
    from .mesh import make_mesh
    return make_mesh(axis_names=axis_names)


def local_block_slices(global_shape, host_shape=None):
    """(y_slice, x_slice) of this process's contiguous block of a
    (Y, X) field laid out on a global_mesh(host_shape=...) mesh.

    Blocks concatenate in host-grid row-major order, matching
    global_field's process-local assembly."""
    n_hosts = jax.process_count()
    if host_shape is None:
        host_shape = (n_hosts, 1)
    hy, hx = int(host_shape[0]), int(host_shape[1])
    gy, gx = global_shape
    if gy % hy or gx % hx:
        raise ValueError(
            f"global shape {global_shape} must divide host grid "
            f"{(hy, hx)}")
    r, c = divmod(jax.process_index(), hx)
    by, bx = gy // hy, gx // hx
    return slice(r * by, (r + 1) * by), slice(c * bx, (c + 1) * bx)


def _local_rank(dev, devices) -> int:
    same = [d for d in devices if d.process_index == dev.process_index]
    return sorted(same, key=lambda d: d.id).index(dev)


def global_field(local_block: np.ndarray, mesh: Mesh,
                 spec: P = P("y", "x")) -> jax.Array:
    """Global sharded array from this host's block of the field.

    local_block must be this process's contiguous slice along the sharded
    axes; blocks concatenate in process order.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_block)


def replicate(value, mesh: Mesh) -> jax.Array:
    """Replicate a (small) array on every device - the observation
    vectors' layout. All processes must pass identical values."""
    sharding = NamedSharding(mesh, P())
    value = np.asarray(value)
    return jax.make_array_from_process_local_data(sharding, value)


def gather_to_host(garr: jax.Array) -> np.ndarray:
    """Fetch a fully-addressable copy of a global array on every host."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(garr, tiled=True))


def make_distributed_step(mesh: Mesh, structure, halfwidth: int,
                          statistic: int, max_points: int,
                          allow_extrapolation: bool = True,
                          field_keys=("x", "y", "z", "elev", "laf"),
                          block: int = 4096):
    """North-star pipeline over the global mesh, one jitted program.

    Returns step(background (Y, X) sharded P('y','x'),
                 p1_fields dict of (Y, X) sharded,
                 obs_fields dict of (P,) replicated,
                 pobs/pbackground/ratios (P,) replicated) -> analysis
    sharded P('y','x').

    Neighbourhood: halo exchange (ppermute: within a host over its own
    links, across the host boundary over the network) + local stencil. OI: each shard solves its own
    gridpoints against the replicated observation set (oi_block_dense),
    no collectives. The per-shard OI is chunked over `block`-gridpoint
    slabs with lax.map so only a (block, n_obs) rho panel is live instead
    of a (tile, n_obs) matrix in device memory.
    """
    h = int(halfwidth)
    statistic = int(statistic)
    block = int(block)
    p1_spec = {k: P("y", "x") for k in field_keys}
    obs_spec = {k: P() for k in field_keys}

    @partial(shard_map, mesh=mesh,
             in_specs=(P("y", "x"), p1_spec, obs_spec, P(), P(), P()),
             out_specs=P("y", "x"), check_vma=False)
    def step(bg_tile, p1_tiles, obs_fields, pobs, pbg, ratios):
        padded = halo_exchange_2d(bg_tile, h)
        sm = nops.neighbourhood(padded, h, statistic)
        if h > 0:
            sm = sm[h:-h, h:-h]
        ty, tx = sm.shape
        n = ty * tx
        nb = -(-n // block)
        pad = nb * block - n
        flat_bg = jnp.pad(sm.reshape(-1), (0, pad)).reshape(nb, block)
        p1 = {k: jnp.pad(v.reshape(-1), (0, pad)).reshape(nb, block)
              for k, v in p1_tiles.items()}

        def solve_slab(slab):
            bg, fields = slab
            out, _ = oi_block_dense(
                structure, {k: v[:, None] for k, v in fields.items()},
                obs_fields, bg, jnp.ones_like(bg), pobs, pbg, ratios,
                int(max_points), bool(allow_extrapolation))
            return out

        out = jax.lax.map(solve_slab, (flat_bg, p1))
        return out.reshape(-1)[:n].reshape(ty, tx)

    return jax.jit(step)
