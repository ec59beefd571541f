"""chip_smoke.py and bench.py: every phase passes at a small size on the CPU,
and both scripts refuse to run without a GPU.  Also: where the compile
cache goes."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()
SHIFT = 14  # BASELINE sizes / 2^14: 2^14 keys, 6103 join rows per side


@pytest.mark.parametrize("name", list(smoke.PHASES))
def test_phase_passes_small(name):
    smoke.run([name], seed=3, shift=SHIFT)


def test_dist_phase_passes_small():
    # the --chips 4 phase on four virtual CPU devices
    smoke.run(["dist"], seed=5, shift=SHIFT, n_dev=4)


def test_phase_check_catches_a_wrong_answer():
    op, check = smoke.phase_sort(1 << 10, 0)
    good, perm = op()
    with pytest.raises(AssertionError, match="sort uniform"):
        check((good[::-1], perm))


def _run_script(*args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_cpu(script):
    r = _run_script(str(REPO / script))
    assert r.returncode != 0
    assert "GPU" in r.stderr
    assert '"ok": true' not in r.stdout


def _cache_dir(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = "import jax, radx_tpu; print(jax.config.jax_compilation_cache_dir)"
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300, check=True,
    )
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("preset", [False, True], ids=["unset", "set"])
def test_compile_cache_placement(tmp_path, preset):
    if preset:
        # JAX's own setting wins; the package sets nothing
        assert _cache_dir(str(tmp_path)) == str(tmp_path)
    else:
        assert _cache_dir(None) == str(REPO / ".jax_cache")


def test_gpu_fixture_skips_here(request):
    # the `gpu` fixture decides at run time; under JAX_PLATFORMS=cpu it
    # skips, which pytest reports as a skip, not a failure
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(pytest.skip.Exception):
        request.getfixturevalue("gpu")
