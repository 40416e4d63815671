"""Command-line entry points that need no accelerator to be checked here:
the compile-cache helper, and chip_smoke.py / bench.py refusing to run
without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


_CACHE_PROBE = (
    "import jax; from mitsuba3_experiments_tpu.utils.cache import "
    "enable_compile_cache as e; d = e(); "
    "print(d); print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("with_env", [True, False], ids=["env", "default"])
def test_compile_cache_dir(tmp_path, with_env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache is <checkout>/.jax_cache.  In a subprocess, so this test
    process's JAX config is untouched."""
    if with_env:
        out = _run(["-c", _CACHE_PROBE],
                   {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        want = str(tmp_path)
    else:
        out = _run(["-c", _CACHE_PROBE], drop=("JAX_COMPILATION_CACHE_DIR",))
        want = os.path.join(REPO, ".jax_cache")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, want]


def test_chip_smoke_refuses_cpu():
    out = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"}, cwd=tmp_path,
               drop=("PYTHONPATH",))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_refuses_cpu():
    out = _run(["bench.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs a GPU" in out.stderr
