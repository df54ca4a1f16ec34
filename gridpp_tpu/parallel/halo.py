"""Halo exchange for spatially sharded fields.

Inside shard_map, each shard holds a (Y/py, X/px) tile. Stencil ops of
halfwidth h need the h-deep strips of the 4 (8 with corners) neighbouring
shards. Strips move between devices with `lax.ppermute`; shards at the domain
boundary receive a NaN halo, which the NaN-skipping stencil kernels treat
exactly like the reference's clipped-at-the-edge windows - so the sharded
result is bitwise-equivalent in structure to the single-chip one.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["halo_exchange_2d"]


def _shift(x, axis_name: str, up: bool):
    """Send x to the next (up=False) or previous (up=True) shard along
    axis_name. Shards with no sender receive NaN."""
    n = lax.axis_size(axis_name)
    if up:
        perm = [(i, i - 1) for i in range(1, n)]
    else:
        perm = [(i, i + 1) for i in range(n - 1)]
    got = lax.ppermute(x, axis_name, perm)
    marker = lax.ppermute(jnp.ones((), x.dtype), axis_name, perm)
    return jnp.where(marker == 1, got, jnp.nan)


def halo_exchange_2d(tile: jax.Array, h: int, y_axis: str = "y",
                     x_axis: str = "x") -> jax.Array:
    """Pad a (..., Ty, Tx) tile with h-deep halos from neighbouring shards.

    Returns (..., Ty+2h, Tx+2h). Corners are exchanged implicitly by doing
    the y-pass first and including its halos in the x-pass strips.
    """
    if h == 0:
        return tile
    ty = tile.shape[-2]
    # --- y direction ---
    top_strip = tile[..., :h, :]      # our top rows -> previous shard's view
    bot_strip = tile[..., ty - h:, :]
    from_above = _shift(bot_strip, y_axis, up=False)  # prev shard's bottom
    from_below = _shift(top_strip, y_axis, up=True)   # next shard's top
    tile_y = jnp.concatenate([from_above, tile, from_below], axis=-2)
    # --- x direction (strips include y halos -> corners come for free) ---
    tx = tile_y.shape[-1]
    left_strip = tile_y[..., :, :h]
    right_strip = tile_y[..., :, tx - h:]
    from_left = _shift(right_strip, x_axis, up=False)
    from_right = _shift(left_strip, x_axis, up=True)
    return jnp.concatenate([from_left, tile_y, from_right], axis=-1)
