"""Parametric BVH layout (scene/bvh8.BVHLayout).

Round-4 config consolidation: the layout is an explicit dataclass passed to
build_bvh / load_dict and stamped on the built BVH as static aux data, so
non-default settings are exercised IN-PROCESS (they were import-time env
globals before, testable only via subprocess).  Each case checks BVH
traversal against the brute-force oracle on a multi-object scene, and one
case drives the persistent state machine end-to-end on a non-default
stack/row layout.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from mitsuba3_experiments_tpu.core.records import Ray
from mitsuba3_experiments_tpu.intersect.bvh_jax import (
    ray_intersect,
    ray_intersect_brute,
)
from mitsuba3_experiments_tpu.scene import cornell_box, load_dict
from mitsuba3_experiments_tpu.scene.bvh8 import BVHLayout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAYOUTS = [
    BVHLayout(width=16),
    BVHLayout(leaf_cap=16),
    BVHLayout(width=16, leaf_cap=16),
    # object-split-only build (spatial splits disabled)
    BVHLayout(sbvh=False),
    # aggressive spatial splitting: near-zero overlap threshold forces
    # many duplicated references through the oracle equality
    BVHLayout(sbvh=True, sbvh_alpha=1e-9),
    # SA-greedy collapse on the SBVH tree
    BVHLayout(collapse="area"),
]


def _ids(lay):
    return (f"w{lay.width}c{lay.leaf_cap}-{lay.collapse}"
            f"{'-sbvh' + format(lay.sbvh_alpha, 'g') if lay.sbvh else ''}")


def _oracle_scene(layout):
    scene, _ = load_dict(cornell_box(res=16, spp=1), bvh_layout=layout)
    assert scene.bvh.layout == layout
    return scene


@pytest.mark.slow
@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_nondefault_layout_matches_brute_force(layout):
    scene = _oracle_scene(layout)
    rng = np.random.default_rng(5)
    n = 2048
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray.make(jnp.asarray(o), jnp.asarray(d))
    si = ray_intersect(scene, ray)
    sb = ray_intersect_brute(scene, ray)
    np.testing.assert_array_equal(
        np.asarray(si.prim_idx), np.asarray(sb.prim_idx)
    )
    np.testing.assert_allclose(
        np.asarray(si.t), np.asarray(sb.t), rtol=1e-5, atol=1e-5
    )


@pytest.mark.slow
def test_persistent_renderer_on_nondefault_layout():
    """The persistent state machine reads row offsets + stack depth from
    the scene BVH's layout: a wider-leaf tree must render the same image
    as the default layout (different row geometry, same estimates — RNG is
    keyed by camera-ray index, not tree shape)."""
    from mitsuba3_experiments_tpu.integrators.persistent import (
        render_persistent,
    )

    kw = dict(seed=7, spp=2, max_depth=4, rr_depth=2, n_lanes=1024,
              steps=8, rounds_per_launch=4)
    img_a = np.asarray(render_persistent(
        _oracle_scene(BVHLayout()), **kw))
    img_b = np.asarray(render_persistent(
        _oracle_scene(BVHLayout(leaf_cap=16, sbvh=False)), **kw))
    np.testing.assert_allclose(img_b, img_a, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_env_shim_still_configures_default_layout():
    """The thin M3T_* env shim (BVHLayout.from_env) keeps A/B runs
    working without code edits."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "from mitsuba3_experiments_tpu.scene.bvh8 import DEFAULT_LAYOUT;"
        "assert DEFAULT_LAYOUT.leaf_cap == 16, DEFAULT_LAYOUT;"
        "assert not DEFAULT_LAYOUT.sbvh;"
        "print('SHIM_OK')"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "M3T_LEAF_CAP": "16", "M3T_SBVH": "0",
             "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "SHIM_OK" in r.stdout
