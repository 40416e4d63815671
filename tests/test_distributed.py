"""Multi-PROCESS distributed execution (VERDICT r4 #5): actually runs the
jax.distributed code path SURVEY.md §2.3 claims ("multi-host init — same
code path"), as 2 coordinator-connected processes x 4 virtual CPU devices
each, and checks render_sharded / sharded_replay_grad equality against the
single-process 8-device result.

The workers are this file's `__main__` mode (fresh interpreters so each
can own its JAX runtime + Gloo collectives); process 0 writes results to a
temp dir and the pytest parent — which holds the usual single-process
8-device CPU mesh from conftest — compares.  This is the multi-host init
path: cross-process collectives ride Gloo here and NCCL across GPU hosts,
with identical program code either way.

Launch recipe (what a real 2-host run does, one line per host):
  host0: python -c "import jax; \
      jax.distributed.initialize('host0:8476', 2, 0); ..."
  host1: python -c "import jax; \
      jax.distributed.initialize('host0:8476', 2, 1); ..."
(the coordinator address, process count and id are always passed
explicitly; nothing here autodetects a cluster).
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPP, DEPTH, RES, SEED = 2, 3, 32, 4


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(pid: int, port: int, outdir: str):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4

    import jax.numpy as jnp

    from mitsuba3_experiments_tpu.integrators import PathIntegrator, render
    from mitsuba3_experiments_tpu.parallel import (
        make_mesh,
        render_sharded,
        sharded_replay_grad,
    )
    from mitsuba3_experiments_tpu.scene import cornell_box, load_dict

    def fetch(a):
        # replicated global arrays span both processes' devices, so
        # np.asarray would refuse; any addressable copy is the value
        return np.asarray(a.addressable_shards[0].data)

    scene, _ = load_dict(cornell_box(res=RES, spp=1))
    mesh = make_mesh()  # all 8 devices, 4 per process
    integ = PathIntegrator(max_depth=DEPTH, rr_depth=2)
    img = render_sharded(scene, integ, mesh, spp=SPP, seed=SEED + 1)

    n = RES * RES * SPP
    target = jnp.zeros((RES, RES, 3), jnp.float32)
    params = {
        "materials.base_color": scene.materials.base_color,
        "emitters.radiance": scene.emitters.radiance,
    }
    per = (n + 7) // 8
    loss, grads = sharded_replay_grad(
        scene, params, target, SEED, mesh, idx0=0, n_lanes=per, spp=SPP,
        max_depth=DEPTH, rr_depth=2, rfilter="box", steps=8,
        rounds_per_launch=4, ray_end=n, scheduler="pipelined",
    )
    if pid == 0:
        np.savez(
            os.path.join(outdir, "result.npz"),
            img=fetch(img),
            loss=fetch(loss),
            **{k: fetch(v) for k, v in grads.items()},
        )
    # both processes must reach the end together (collectives inside)
    print(f"[worker {pid}] done", flush=True)


@pytest.mark.slow
def test_two_process_distributed_matches_single_process(tmp_path):
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO,
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid),
             str(port), str(tmp_path)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        logs.append(out.decode(errors="replace"))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-4000:]}"

    got = np.load(tmp_path / "result.npz")

    # single-process reference on the conftest 8-device mesh
    import jax.numpy as jnp

    from mitsuba3_experiments_tpu.integrators import PathIntegrator, render
    from mitsuba3_experiments_tpu.integrators.replay import (
        replay_render_grad,
    )
    from mitsuba3_experiments_tpu.scene import cornell_box, load_dict
    from mitsuba3_experiments_tpu.scene import update

    scene, _ = load_dict(cornell_box(res=RES, spp=1))
    integ = PathIntegrator(max_depth=DEPTH, rr_depth=2)
    img1 = np.asarray(render(scene, integ, spp=SPP, seed=SEED + 1))
    np.testing.assert_allclose(got["img"], img1, rtol=1e-4, atol=1e-5)

    n = RES * RES * SPP
    target = jnp.zeros((RES, RES, 3), jnp.float32)
    params = {
        "materials.base_color": scene.materials.base_color,
        "emitters.radiance": scene.emitters.radiance,
    }
    g1 = replay_render_grad(
        scene, params, update, target, SEED, 0, n, spp=SPP,
        max_depth=DEPTH, rr_depth=2, rfilter="box", steps=8,
        rounds_per_launch=4,
    )
    for k in params:
        a, b = np.asarray(g1[k]), got[k]
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(
            b, a, rtol=2e-3, atol=2e-4 * max(1e-9, np.abs(a).max()),
            err_msg=f"grad mismatch for {k}",
        )


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
