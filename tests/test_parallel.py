"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md section 4d):
sharded render equals the single-device render; gradient step all-reduces."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba3_experiments_tpu.integrators import PathIntegrator, render
from mitsuba3_experiments_tpu.parallel import (
    make_mesh,
    render_sharded,
    sharded_grad_step,
)
from mitsuba3_experiments_tpu.scene import cornell_box, load_dict


@pytest.fixture(scope="module")
def box():
    scene, _ = load_dict(cornell_box(res=32, spp=1))
    return scene


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device(box):
    integ = PathIntegrator(max_depth=3, rr_depth=2)
    img1 = np.asarray(render(box, integ, spp=4, seed=5))
    mesh = make_mesh()
    img8 = np.asarray(render_sharded(box, integ, mesh, spp=4, seed=5))
    # same lanes, same RNG (lane index is global) -> bitwise-identical modulo
    # scatter-order float addition; allow tiny tolerance
    np.testing.assert_allclose(img8, img1, rtol=1e-4, atol=1e-5)


def test_sharded_render_uneven_wavefront(box):
    # 32*32 = 1024 lanes over 8 devices divides; use a 6-device mesh for a
    # non-dividing case (1024 % 6 != 0) to exercise the padding path
    integ = PathIntegrator(max_depth=2)
    mesh = make_mesh(6)
    img = np.asarray(render_sharded(box, integ, mesh, spp=1, seed=1))
    assert np.isfinite(img).all()
    img1 = np.asarray(render(box, integ, spp=1, seed=1))
    np.testing.assert_allclose(img, img1, rtol=1e-4, atol=1e-5)


def test_sharded_render_chunked_matches_single_device(box):
    # chunked per-device launches (VERDICT r1 #8): chunk*ndev = 384 does not
    # divide the 1024-lane wavefront, so the final launch wraps lanes to 0;
    # wrapped lanes re-trace lane 0 bit-identically so the weighted film
    # average is unchanged and the image equals the single-device render
    integ = PathIntegrator(max_depth=3, rr_depth=2)
    img1 = np.asarray(render(box, integ, spp=2, seed=7))
    mesh = make_mesh()
    img8 = np.asarray(
        render_sharded(box, integ, mesh, spp=2, seed=7, chunk=48)
    )
    np.testing.assert_allclose(img8, img1, rtol=1e-4, atol=1e-5)


def test_sharded_grad_step_allreduce(box):
    integ = PathIntegrator(max_depth=3, rr_depth=2, differentiable=True)
    mesh = make_mesh()
    params = {"emitters.radiance": box.emitters.radiance}
    target = jnp.zeros((32, 32, 3), jnp.float32)
    loss, grads = sharded_grad_step(
        box, params, target, jnp.uint32(0), mesh, integ, spp_per_pass=1
    )
    g = np.asarray(grads["emitters.radiance"])
    assert np.isfinite(float(loss))
    assert np.abs(g).max() > 0
    assert g.shape == (1, 3)
    # the all-reduced gradient must be mesh-size invariant (the psum
    # transpose inflates per-device cotangents by ndev; psum/ndev corrects)
    _, grads4 = sharded_grad_step(
        box, params, target, jnp.uint32(0), make_mesh(4), integ,
        spp_per_pass=1,
    )
    np.testing.assert_allclose(
        np.asarray(grads4["emitters.radiance"]), g, rtol=1e-4, atol=1e-6
    )


def test_persistent_sharded_matches_single_device(box):
    """Sharded persistent renderer == single-device persistent renderer:
    per-device state machines over owned ray ranges, global-index RNG."""
    from mitsuba3_experiments_tpu.integrators.persistent import (
        render_persistent,
    )
    from mitsuba3_experiments_tpu.parallel import render_persistent_sharded

    img1 = np.asarray(
        render_persistent(box, spp=2, max_depth=3, n_lanes=512, steps=8,
                          rounds_per_launch=4, seed=3)
    )
    mesh = make_mesh()
    img8 = np.asarray(
        render_persistent_sharded(box, mesh, spp=2, max_depth=3,
                                  n_lanes=128, steps=8,
                                  rounds_per_launch=4, seed=3)
    )
    np.testing.assert_allclose(img8, img1, rtol=1e-4, atol=1e-5)

    # the two-path pipelined machine composes over the mesh identically
    img8p = np.asarray(
        render_persistent_sharded(box, mesh, spp=2, max_depth=3,
                                  n_lanes=64, steps=8,
                                  rounds_per_launch=4, seed=3,
                                  scheduler="pipelined")
    )
    np.testing.assert_allclose(img8p, img1, rtol=1e-4, atol=1e-5)

    # chunked arming under shard_map (scheduling-independence again)
    img8a = np.asarray(
        render_persistent_sharded(box, mesh, spp=2, max_depth=3,
                                  n_lanes=64, steps=8,
                                  rounds_per_launch=4, seed=3,
                                  scheduler="pipelined", arm_every=3)
    )
    np.testing.assert_allclose(img8a, img1, rtol=1e-4, atol=1e-5)


def test_sharded_replay_grad_matches_single_device(box):
    """Multi-device record+replay fwd+bwd == single-device replay grads."""
    from mitsuba3_experiments_tpu.integrators.replay import (
        replay_render_grad,
    )
    from mitsuba3_experiments_tpu.parallel import sharded_replay_grad
    from mitsuba3_experiments_tpu.scene import update

    w, h = box.camera.resolution
    spp, depth = 2, 3
    n = w * h * spp
    target = jnp.asarray(
        render(box, PathIntegrator(max_depth=depth), seed=7, spp=spp,
               rfilter="box")
    )
    params = {
        "materials.base_color": box.materials.base_color,
        "emitters.radiance": box.emitters.radiance,
    }
    g1 = replay_render_grad(
        box, params, update, target, 4, 0, n, spp=spp, max_depth=depth,
        rr_depth=2, rfilter="box", steps=8, rounds_per_launch=4,
    )
    mesh = make_mesh()
    per = (n + 7) // 8
    loss, g8 = sharded_replay_grad(
        box, params, target, 4, mesh, idx0=0, n_lanes=per, spp=spp,
        max_depth=depth, rr_depth=2, rfilter="box", steps=8,
        rounds_per_launch=4, ray_end=n,
    )
    assert np.isfinite(float(loss))
    for k in params:
        a, b = np.asarray(g1[k]), np.asarray(g8[k])
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(b, a, rtol=2e-3,
                                   atol=2e-4 * max(1e-9, np.abs(a).max()))

    # production shape (VERDICT r3 #4): fewer lanes than rays per device —
    # the refill+flush recorder (_run_record_full) — plus chunked replay;
    # gradients must be unchanged
    half = max(per // 2, 16)
    loss2, g8b = sharded_replay_grad(
        box, params, target, 4, mesh, idx0=0, n_lanes=half, spp=spp,
        max_depth=depth, rr_depth=2, rfilter="box", steps=8,
        rounds_per_launch=4, ray_end=n, chunk=half,
    )
    np.testing.assert_allclose(float(loss2), float(loss), rtol=1e-4)
    for k in params:
        a, b = np.asarray(g1[k]), np.asarray(g8b[k])
        np.testing.assert_allclose(b, a, rtol=2e-3,
                                   atol=2e-4 * max(1e-9, np.abs(a).max()))

    # the pipelined recorder under shard_map (chunked arming on: the
    # record must be scheduling-independent here too): same loss + grads
    loss3, g8c = sharded_replay_grad(
        box, params, target, 4, mesh, idx0=0, n_lanes=half, spp=spp,
        max_depth=depth, rr_depth=2, rfilter="box", steps=8,
        rounds_per_launch=4, ray_end=n, chunk=half,
        scheduler="pipelined", arm_every=2,
    )
    np.testing.assert_allclose(float(loss3), float(loss), rtol=1e-4)
    for k in params:
        a, b = np.asarray(g8b[k]), np.asarray(g8c[k])
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-6 * max(1e-9, np.abs(a).max()))
