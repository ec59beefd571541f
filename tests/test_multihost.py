"""Multi-host distributed sort: 2 OS processes x 2 virtual CPU devices,
coordinator over localhost — BASELINE config 5's ">= 2 hosts" without a pod.

The collectives in parallel/dist_sort (all_gather / all_to_all / ppermute)
cross a real process boundary here, exercising the DCN-shaped path the
virtual single-process mesh cannot.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_import_does_not_initialize_backend():
    """jax.distributed.initialize must run before any backend touch, so
    importing radx_tpu must never execute a jitted op (regression: a
    module-level jnp scalar once broke every multi-host worker)."""
    code = (
        "import os;"
        "os.environ['JAX_PLATFORMS'] = 'cpu';"
        "import radx_tpu;"
        "import jax._src.xla_bridge as xb;"
        # the private registry is version-fragile: fail LOUDLY if it moves
        # rather than silently passing a vacuous assert (ADVICE r2)
        "assert hasattr(xb, '_backends'), ("
        "    'jax._src.xla_bridge._backends moved — update this test to the'"
        "    ' new backend-initialization signal');"
        "assert not xb._backends, 'importing radx_tpu initialized XLA'"
    )
    env = dict(os.environ)
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=REPO, env=env,
        timeout=120,
    )


@pytest.mark.slow
def test_two_process_global_sort():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    n = 1 << 15
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(i), str(n)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=REPO,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK proc={i}" in out, out[-4000:]
