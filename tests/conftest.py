"""Test configuration: run everything on an 8-device virtual CPU mesh so
multi-device sharding is exercised without GPUs (SURVEY.md §4d). Pallas
kernels run in the interpreter where a test asks for it explicitly."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

# Build the native C++ runtime when a toolchain is available so the
# byte-identical parity tests (tests/test_native.py) run by default
# instead of silently skipping. `make` is a no-op
# when libtpt_native.so is already newer than its source.
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
if shutil.which("make") and shutil.which("g++"):
    _build = subprocess.run(
        ["make", "-C", _NATIVE_DIR],
        capture_output=True, text=True,
    )
    if _build.returncode != 0:
        print(
            "conftest: native build failed — parity tests will skip\n"
            + _build.stderr,
            file=sys.stderr,
        )
else:
    print(
        "conftest: no C++ toolchain — native parity tests will skip",
        file=sys.stderr,
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped on the CPU — chip_smoke.py runs "
        "the same checks on the card",
    )
