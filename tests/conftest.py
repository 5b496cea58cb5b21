"""Test configuration: JAX runs on a virtual 8-device CPU mesh so all
sharding / multi-device tests run without an accelerator (SURVEY.md §4).

The platform defaults to cpu before JAX is imported, and
`jax.config.update` pins it even if another plugin registered first.
Tests that need a GPU carry the `gpu` marker and skip on the CPU; on the
card, run them with:
JAX_PLATFORMS=cuda python -m pytest tests/test_ldpc_pallas.py -m gpu"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
