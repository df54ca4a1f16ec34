"""Accelerator bring-up shared by the entry points that run on the GPU
(chip_smoke.py, bench.py, the CLI driver): the device gate, the card's
name and power limit, and JAX's persistent compilation cache.
"""
from __future__ import annotations

import os
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))

__all__ = ["NoGPUError", "card_label", "checkout", "enable_compile_cache",
           "require_gpu"]


class NoGPUError(RuntimeError):
    """JAX found no GPU."""


def checkout() -> str | None:
    """The repository checkout that holds this package (its root has
    chip_smoke.py or .git), or None for an installed package."""
    root = os.path.dirname(PACKAGE_DIR)
    if any(os.path.exists(os.path.join(root, marker))
           for marker in ("chip_smoke.py", ".git")):
        return root
    return None


def enable_compile_cache() -> str | None:
    """Keep JAX's persistent compilation cache in one fixed directory.

    JAX_COMPILATION_CACHE_DIR wins when it is set (JAX reads it itself,
    and no other directory is set here). Otherwise, in a checkout, the
    cache lives in <checkout>/.jax_cache: a fixed path, because the path
    is part of what makes a later process find the entries again. An
    installed package writes nothing into its install tree and keeps no
    persistent cache. Returns the directory in use, or None.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    root = checkout()
    if root is None:
        return None
    import jax
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """jax.devices(), or NoGPUError unless the first device is a GPU.

    There is no CPU fallback: a measurement or a check that meant the
    card must not quietly run on the host.
    """
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoGPUError(f"no GPU found: jax.devices() = {devices}")
    return devices


def card_label() -> str:
    """`name, power.limit` of every card, one line each, as nvidia-smi
    prints them.

    nvidia-smi runs in a child process that never imports JAX, so it
    holds no device memory. Returns a message in place of the label
    when nvidia-smi is missing or fails.
    """
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    if proc.returncode != 0:
        return f"nvidia-smi failed (rc={proc.returncode})"
    return "\n".join(line.strip() for line in proc.stdout.splitlines()
                     if line.strip())
