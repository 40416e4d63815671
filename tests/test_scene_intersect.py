"""Scene compile + BVH + intersection tests: BVH vs brute-force oracle,
analytic plane hits, watertightness on the cornell box."""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba3_experiments_tpu.core import math as m
from mitsuba3_experiments_tpu.core.records import Ray
from mitsuba3_experiments_tpu.intersect import (
    ray_intersect,
    ray_intersect_brute,
    ray_test,
)
from mitsuba3_experiments_tpu.scene import cornell_box, load_dict


@pytest.fixture(scope="module")
def box():
    scene, meta = load_dict(cornell_box(res=64, spp=4))
    return scene


def _random_rays(n, rng, origin_box=0.9):
    o = rng.uniform(-origin_box, origin_box, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Ray.make(jnp.asarray(o), jnp.asarray(d))


def test_scene_compile(box):
    assert box.n_faces == 6 * 2 + 2 * 12  # 6 rects (incl. light) + 2 cubes
    assert int(box.emitters.em_face.shape[0]) == 2
    assert box.camera.resolution == (64, 64)


def test_bvh_matches_brute_force(box, rng_np):
    ray = _random_rays(512, rng_np)
    si_b = ray_intersect_brute(box, ray)
    si = ray_intersect(box, ray)
    np.testing.assert_array_equal(
        np.asarray(si.prim_idx), np.asarray(si_b.prim_idx)
    )
    np.testing.assert_allclose(
        np.asarray(si.t), np.asarray(si_b.t), rtol=1e-5, atol=1e-6
    )


def test_rays_from_inside_always_hit(box, rng_np):
    # the box is open at the front (+z, behind the camera) like Mitsuba's
    # cornell box; any interior ray pointed away from the opening must hit.
    o = rng_np.uniform(-0.9, 0.9, size=(2048, 3)).astype(np.float32)
    d = rng_np.normal(size=(2048, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.1  # aim towards the back
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    si = ray_intersect(box, Ray.make(jnp.asarray(o), jnp.asarray(d)))
    assert bool(jnp.all(si.valid)), f"{int(jnp.sum(~si.valid))} rays escaped"


def test_analytic_back_wall(box):
    # ray from origin straight to the back wall at z = -1
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    si = ray_intersect(box, Ray.make(o, d))
    np.testing.assert_allclose(float(si.t[0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(si.p[0]), [0, 0, -1], atol=1e-5
    )
    # geometric normal faces the origin (+z)
    np.testing.assert_allclose(np.asarray(si.n[0]), [0, 0, 1], atol=1e-5)
    # wi in local frame is +z (head-on)
    np.testing.assert_allclose(float(si.wi[0, 2]), 1.0, atol=1e-5)


def test_maxt_respected(box):
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    si = ray_intersect(box, Ray(o=o, d=d, maxt=jnp.array([0.5])))
    assert not bool(si.valid[0])


def test_ray_test_occlusion(box):
    o = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    maxt = jnp.array([2.0, 0.5])
    occ = ray_test(box, Ray(o=o, d=d, maxt=maxt))
    assert bool(occ[0]) and not bool(occ[1])


def test_inactive_lanes(box):
    ray = _random_rays(8, np.random.default_rng(1))
    active = jnp.zeros(8, bool)
    si = ray_intersect(box, ray, active)
    assert not bool(jnp.any(si.valid))


def test_emitter_faces_found(box):
    # shoot straight up from center: must hit the light (emitter_id >= 0)
    o = jnp.array([[0.0, 0.0, 0.01]])
    d = jnp.array([[0.0, 1.0, 0.0]])
    si = ray_intersect(box, Ray.make(o, d))
    assert bool(si.valid[0])
    assert int(si.emitter_id[0]) >= 0
    np.testing.assert_allclose(float(si.t[0]), 0.99, atol=1e-4)


def test_bedroom_class_mesh_bvh(rng_np):
    # a denser mesh (sphere, ~4k tris): BVH == brute force
    from mitsuba3_experiments_tpu.scene import mesh as meshlib

    sph = meshlib.sphere(radius=1.0, n_theta=32, n_phi=64)
    d = {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45.0},
        "s": {
            "type": "mesh",
            "vertices": sph.vertices,
            "faces": sph.faces,
            "normals": sph.normals,
            "bsdf": {"type": "diffuse"},
        },
    }
    scene, _ = load_dict(d)
    o = rng_np.uniform(-3, 3, size=(256, 3)).astype(np.float32)
    o = o[np.linalg.norm(o, axis=-1) > 1.5]
    tgt = rng_np.uniform(-0.5, 0.5, size=(o.shape[0], 3)).astype(np.float32)
    dirs = tgt - o
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ray = Ray.make(jnp.asarray(o), jnp.asarray(dirs))
    si_b = ray_intersect_brute(scene, ray)
    si = ray_intersect(scene, ray)
    np.testing.assert_array_equal(np.asarray(si.valid), np.asarray(si_b.valid))
    np.testing.assert_allclose(
        np.asarray(si.t)[np.asarray(si.valid)],
        np.asarray(si_b.t)[np.asarray(si_b.valid)],
        rtol=1e-4,
    )
    # all these rays aim at the sphere's interior box, so they must hit
    assert bool(jnp.all(si.valid))


def test_native_bvh_matches_numpy_builder():
    """The C++ binned-SAH builder must produce the same tree as the numpy
    reference implementation (same bins, same stop rule)."""
    from mitsuba3_experiments_tpu.scene import mesh as meshlib
    from mitsuba3_experiments_tpu.scene.bvh import _build_bvh_numpy
    from mitsuba3_experiments_tpu.scene.native import (
        build,
        try_build_bvh_native,
    )

    build()
    sph = meshlib.sphere(radius=1.0, n_theta=24, n_phi=48)
    native = try_build_bvh_native(sph.vertices, sph.faces, 4)
    ref = _build_bvh_numpy(sph.vertices, sph.faces, 4)
    lo, hi, left, right, first, count, order, max_leaf = native
    r_lo, r_hi, r_left, r_right, r_first, r_count, r_order = ref
    assert left.shape[0] == r_left.shape[0]
    assert max_leaf <= 4
    # leaves partition the primitive set identically in size distribution
    assert sorted(count[left == -1].tolist()) == sorted(
        r_count[r_left == -1].tolist()
    )
