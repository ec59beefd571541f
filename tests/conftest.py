"""Test harness config: run everything on a virtual 8-device CPU mesh.

The operators are plain XLA, so the same code the GPU runs is tested on the
CPU backend; sharding is validated on a virtual 8-device CPU mesh.  Tests
that need the card carry the `gpu` marker and skip here (see the `gpu`
fixture); on the card run them with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.  Must set env vars
before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402


import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0x5ADF00D)


# --- test tiers -------------------------------------------------------------
# tests/slow_tests.txt lists node ids measured >= ~4 s on the CPU backend
# (regenerate from `pytest --durations=0` output); they get the `slow`
# marker so `pytest -m "not slow"` is the fast default tier.  Explicit
# in-file @pytest.mark.slow marks (multi-process, big-shape) still apply.
import pathlib

_SLOW_MANIFEST = pathlib.Path(__file__).parent / "slow_tests.txt"
_SLOW_IDS = frozenset(
    line.strip()
    for line in _SLOW_MANIFEST.read_text().splitlines()
    if line.strip()
) if _SLOW_MANIFEST.exists() else frozenset()


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in _SLOW_IDS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none.  Card
    presence is decided here, at run time, never at import or collection
    (every xdist worker must collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run `pytest -m gpu` on the card")
    return devs[0]
