"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU (JAX_PLATFORMS defaults to cpu here) with 8
virtual devices, so the multi-device sharding paths are validated
without a GPU (SURVEY.md section 4). The device count must be set before
the CPU backend initializes. Tests that need the GPU carry the `chip`
marker and skip on the CPU; on the card run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/test_chip.py`
(the host API needs the cpu backend beside the GPU).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
