"""Test harness: force an 8-device virtual CPU mesh and enable x64.

Multi-device sharding correctness is validated without a GPU cluster by
splitting the host CPU into 8 XLA devices (SURVEY.md section 4d).  x64 is
enabled so the float64 parity path (the reference's -DREAL64 solver
precision) is testable.  The suite runs on the CPU; chip_smoke.py runs the
same paths on the GPU.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
