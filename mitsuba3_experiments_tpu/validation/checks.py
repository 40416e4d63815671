"""Correctness checks of the production path, each with a stated tolerance.

chip_smoke.py runs them on the GPU; the tests run the same functions (at
small sizes on the CPU, at full size in the `gpu`-marked twins).  Nothing
here compares digests or bits: on the GPU, scatter-adds are atomics whose
order changes from run to run, and XLA's autotuning may pick other
kernels, so two correct runs differ in the last bits.  Each function
returns the measured quantities and raises AssertionError when a bound
fails.
"""
from __future__ import annotations

import numpy as np

# f32 transforms against float64: a k-term f32 sum of products is within
# k * 2^-24 of the exact value relative to sum(|terms|) (k <= 16 here), so
# 1e-6 holds on any backend that computes in f32.  TF32 (10 mantissa bits)
# misses it by three orders of magnitude.
TRANSFORM_RTOL = 1e-6


def _bound_check(name, got, ref, scale, rtol=TRANSFORM_RTOL):
    err = np.abs(np.asarray(got, np.float64) - ref)
    worst = float(np.max(err / np.maximum(scale, 1e-30)))
    assert worst <= rtol, f"{name}: error {worst:.3g} x scale > {rtol:g}"
    return worst


def check_transforms(n: int = 1 << 20, seed: int = 0) -> dict:
    """The f32 transform sites (core/math.py, render/sensor.py,
    core/spectrum.py, models/reparam.py) against float64 NumPy, on points
    spread over the bedroom's extent (~8 m)."""
    import jax.numpy as jnp

    from ..core import math as cm
    from ..core import spectrum as sp
    from ..models import reparam as rp
    from ..render import sensor
    from ..scene.flagship import CAMERA_ORIGIN, CAMERA_TARGET
    from ..scene.types import Camera

    rng = np.random.default_rng(seed)
    p = rng.uniform(-3.6, 4.6, (n, 3)).astype(np.float32)
    m4 = cm.matmul4(cm.translate([0.7, -1.3, 2.1]),
                    cm.rotate([0.3, 0.8, -0.5], 37.0),
                    cm.scale_mat([1.7, 0.6, 2.3])).astype(np.float32)
    R, t = m4[:3, :3].astype(np.float64), m4[:3, 3].astype(np.float64)
    p64 = p.astype(np.float64)
    mag = np.abs(p64) @ np.abs(R).T
    out = {}
    out["transform_point"] = _bound_check(
        "transform_point", cm.transform_point(jnp.asarray(m4), jnp.asarray(p)),
        p64 @ R.T + t, mag + np.abs(t))
    out["transform_vector"] = _bound_check(
        "transform_vector", cm.transform_vector(jnp.asarray(m4),
                                                jnp.asarray(p)),
        p64 @ R.T, mag)
    # the reference uses the device's own f32 inverse: this checks the
    # product, not the inversion
    inv_f32 = np.asarray(jnp.linalg.inv(jnp.asarray(m4[:3, :3])), np.float64)
    out["transform_normal"] = _bound_check(
        "transform_normal", cm.transform_normal(jnp.asarray(m4),
                                                jnp.asarray(p)),
        p64 @ inv_f32, np.abs(p64) @ np.abs(inv_f32))

    w, h = 1280, 720
    tw = cm.look_at(CAMERA_ORIGIN, CAMERA_TARGET, [0, 1, 0]).astype(
        np.float32)
    tan = np.float32(np.tan(np.deg2rad(30.0)))
    cam = Camera(to_world=jnp.asarray(tw),
                 tan_half_fov=jnp.asarray([tan, tan * h / w], jnp.float32),
                 resolution=(w, h))
    pos, _, valid = sensor.sample_direction(cam, jnp.asarray(p))
    Rc, tc = tw[:3, :3].astype(np.float64), tw[:3, 3].astype(np.float64)
    pc = (p64 - tc) @ Rc
    th = np.asarray(cam.tan_half_fov, np.float64)
    ref = np.stack([0.5 * (1 - pc[:, 0] / pc[:, 2] / th[0]) * w,
                    0.5 * (1 - pc[:, 1] / pc[:, 2] / th[1]) * h], -1)
    v = np.asarray(valid)
    # film coordinates: the division by depth can amplify the p_cam error,
    # so the scale is the film extent over the relative depth error margin
    scale = (w + np.abs(ref[v])) * (1.0 + (np.abs(p64 - tc).sum(-1)
                                           / np.abs(pc[:, 2]))[v, None])
    out["sample_direction"] = _bound_check(
        "sample_direction", np.asarray(pos)[v], ref[v], scale)
    clip = sensor.perspective_projection(cam)
    inv_tw = np.asarray(jnp.linalg.inv(jnp.asarray(tw)), np.float64)
    proj = np.array([[-0.5, 0, 0.5, 0], [0, -0.5, 0.5, 0],
                     [0, 0, 1000 / (1000 - 0.01), -0.01 * 1000 / (1000 - 0.01)],
                     [0, 0, 1, 0]], np.float32).astype(np.float64)
    sc = np.diag([1 / np.float32(th[0]), 1 / np.float32(th[1]), 1, 1])
    out["perspective_projection"] = _bound_check(
        "perspective_projection", clip, proj @ sc @ inv_tw,
        np.abs(proj) @ np.abs(sc) @ np.abs(inv_tw))

    xyz = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    M = sp.XYZ_TO_SRGB.astype(np.float64)
    out["xyz_to_srgb"] = _bound_check(
        "xyz_to_srgb", sp.xyz_to_srgb(jnp.asarray(xyz), white_balance=False),
        xyz.astype(np.float64) @ M.T, np.abs(xyz.astype(np.float64))
        @ np.abs(M).T)

    hw = rng.normal(size=(16, 16)).astype(np.float32)
    hb = rng.normal(size=(16,)).astype(np.float32)
    hz = rng.normal(size=(n // 16, 16)).astype(np.float32)
    layer = [{"w": jnp.asarray(hw), "b": jnp.asarray(hb)}]
    z64 = hz.astype(np.float64)
    out["reparam_apply_map"] = _bound_check(
        "reparam_apply_map", rp.apply_map(layer, jnp.asarray(hz)),
        z64 @ hw.astype(np.float64) + hb,
        np.abs(z64) @ np.abs(hw.astype(np.float64)) + np.abs(hb))
    return out


# Cornell box vs the NumPy oracle: the block-mean bounds of
# tests/test_golden_oracle.py — both renderers are unbiased, so block means
# agree within SIGMA_MULT oracle sigmas plus a 3% floor, and the global
# means within 2.5%.
ORACLE_SIGMA_MULT = 8.0


def _oracle_blocks(img, b):
    h, w, _ = img.shape
    return img.reshape(h // b, b, w // b, b, 3).mean(axis=(1, 3)).mean(-1)


def check_cornell_oracle(res: int = 32, spp: int = 128, depth: int = 8,
                         k_seeds: int = 4, block: int = 4) -> dict:
    """Path-MIS (lockstep render on the default device) on the Cornell box
    against validation/oracle.py, an independent NumPy tracer."""
    from ..integrators import PathIntegrator, render
    from ..scene import cornell_box, load_dict
    from .oracle import render_oracle, scene_to_numpy

    scene, _ = load_dict(cornell_box(res=res))
    data = scene_to_numpy(scene)
    imgs = np.stack([render_oracle(data, spp=spp, max_depth=depth, seed=s)
                     for s in range(k_seeds)])
    blk = np.stack([_oracle_blocks(i, block) for i in imgs])
    blk_mean, blk_sigma = blk.mean(0), blk.std(0, ddof=1)
    img = np.asarray(render(scene, PathIntegrator(max_depth=depth,
                                                  rr_depth=depth + 1),
                            spp=spp, rfilter="box"), np.float64)
    err = np.abs(_oracle_blocks(img, block) - blk_mean)
    tol = ORACLE_SIGMA_MULT * np.maximum(blk_sigma, 1e-4) + 0.03 * blk_mean
    worst = float(np.max(err / tol))
    rel_mean = float(abs(img.mean() - imgs.mean()) / imgs.mean())
    assert worst <= 1.0, f"cornell block off by {worst:.3f} x its bound"
    assert rel_mean < 0.025, f"cornell global mean off by {rel_mean:.3%}"
    return {"worst_block_over_bound": worst, "global_rel_mean": rel_mean}


# Pipelined vs lockstep on one scene: two unbiased estimators rendered with
# different seeds, so they share no samples and their per-pixel
# differences are independent noise.  Per block, the mean difference must
# lie within PIPE_K_SIGMA standard errors.  The naive error (std of the
# pixel differences / sqrt(pixels)) assumes independent pixels; the tent
# filter splats each sample into 2x2 pixels, which correlates neighbours
# (1/4 per axis for uniform jitter), so a block mean's variance is up to
# (1 + 2/4)^2 = 2.25x the naive one: the error is scaled by
# SE_FACTOR[rfilter].  With a correct error the readings are ~N(0, 1);
# PIPE_K_SIGMA is set from the worst-block readings over several seed
# pairs on the GPU (PERF.md, PR 1).
SE_FACTOR = {"box": 1.0, "tent": 1.5}
PIPE_K_SIGMA = 6.0


def check_pipelined_vs_lockstep(scene, img_pipelined, *, seed: int,
                                spp: int, max_depth: int, rr_depth: int,
                                rfilter: str, block: int = 16,
                                chunk: int | None = None) -> dict:
    """`img_pipelined` (integrators/pipelined.py, rendered with `seed`)
    against the lockstep render() of intersect/bvh_jax, an independent
    traversal, rendered with seed + 1."""
    from ..integrators import PathIntegrator, render

    ref = render(scene, PathIntegrator(max_depth=max_depth,
                                       rr_depth=rr_depth),
                 seed=seed + 1, spp=spp, rfilter=rfilter, chunk=chunk)
    return compare_images(img_pipelined, ref, rfilter=rfilter, block=block)


def compare_images(img, ref, *, rfilter: str, block: int = 16) -> dict:
    """Two independent unbiased estimates of one image agree block by
    block and globally within PIPE_K_SIGMA standard errors of their
    difference."""
    a = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    assert np.isfinite(a).all() and np.isfinite(ref).all()
    d = (a - ref).mean(-1)
    h, w = d.shape
    hb, wb = h // block, w // block
    db = d[:hb * block, :wb * block].reshape(hb, block, wb, block)
    db = db.transpose(0, 2, 1, 3).reshape(hb, wb, -1)
    k = SE_FACTOR[rfilter]
    se = k * db.std(-1, ddof=1) / np.sqrt(db.shape[-1])
    z = np.abs(db.mean(-1)) / np.maximum(se, 1e-7)
    z_global = abs(d.mean()) / max(k * d.std(ddof=1) / np.sqrt(d.size),
                                   1e-9)
    worst = float(z.max())
    assert worst <= PIPE_K_SIGMA, f"block differs by {worst:.2f} sigma"
    assert z_global <= PIPE_K_SIGMA, f"global mean differs by {z_global:.2f}"
    return {"worst_block_sigma": worst, "global_sigma": float(z_global),
            "mean": float(a.mean()), "mean_ref": float(ref.mean())}


# The same rays rendered twice (same seed, same RNG dimensions), e.g. on a
# 4-device mesh and on one device: the images differ only by the order of
# float sums, and by the rare path whose traversal flips at a float tie.
# At most SAME_PIXEL_SHARE of the pixels may differ by more than
# SAME_RTOL x max(|ref|, mean(ref)), and the image means by SAME_RTOL.
SAME_RTOL, SAME_PIXEL_SHARE = 1e-4, 1e-3


def compare_same_samples(img, ref) -> dict:
    """Two renders of the same samples agree pixel by pixel up to float
    reassociation (see SAME_RTOL)."""
    a = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    assert np.isfinite(a).all() and np.isfinite(ref).all()
    scale = np.maximum(np.abs(ref), ref.mean())
    share = float(np.mean((np.abs(a - ref) > SAME_RTOL * scale).any(-1)))
    rel_mean = float(abs(a.mean() - ref.mean()) / ref.mean())
    assert share <= SAME_PIXEL_SHARE, f"{share:.2%} of pixels differ"
    assert rel_mean <= SAME_RTOL, f"means differ by {rel_mean:.3g}"
    return {"pixels_differing": share, "rel_mean": rel_mean,
            "max_abs_diff": float(np.abs(a - ref).max())}


# Replay gradients vs AD through the scan integrator.  Same rays, same RNG
# dimensions, same estimator: the two differ only by the order of float
# sums (the film and gradient scatter-adds are atomics on the GPU, and the
# replay re-associates the per-bounce products).  rtol 5e-3 with an
# absolute floor of 5e-4 x the largest component covers that reassociation
# over ~1e3 rays per parameter; a wrong record or adjoint is off by O(1).
GRAD_RTOL, GRAD_ATOL_FRAC = 5e-3, 5e-4


def check_replay_vs_scan_ad(res: int = 24, spp: int = 2,
                            depth: int = 4) -> dict:
    """record_full_pipelined + replay_grads against jax.grad through
    PathIntegrator(differentiable=True) on the Cornell box, in both replay
    modes bench.forward_backward uses: "full" (depth 8), and "sorted" with
    the recorder's forward film (depth 65), over 8 chunks so the rows are
    sorted across chunks.  Returns {"<mode>:<param>": error / bound}."""
    import jax
    import jax.numpy as jnp

    from ..integrators import PathIntegrator, render
    from ..integrators.pipelined import record_full_pipelined
    from ..integrators.replay import replay_grads
    from ..scene import cornell_box, load_dict, update

    scene, _ = load_dict(cornell_box(res=res))
    n = res * res * spp
    target = render(scene, PathIntegrator(max_depth=depth), seed=9, spp=spp,
                    rfilter="box")
    params = {"materials.base_color": scene.materials.base_color,
              "emitters.radiance": scene.emitters.radiance}
    integ_d = PathIntegrator(max_depth=depth, rr_depth=4, differentiable=True)

    def loss(p):
        img = render(update(scene, p), integ_d, seed=5, spp=spp,
                     rfilter="box")
        return jnp.sum((img - target) ** 2)

    g_ref = jax.grad(loss)(params)
    rec, film = record_full_pipelined(
        scene, 5, n, spp=spp, max_depth=depth, rr_depth=4, steps=8,
        rounds_per_launch=4, n_lanes=max(n // 8, 8), pad_to=n,
        return_film=True, rfilter="box")
    out = {}
    for mode, chunk, kw in (("full", n, {}), ("sorted", n // 8,
                                              {"film": film})):
        g_rep = replay_grads(scene, params, update, target, 5, rec, n,
                             chunk=chunk, spp=spp, max_depth=depth,
                             rr_depth=4, rfilter="box", mode=mode, **kw)
        out.update({f"{mode}:{k}": v
                    for k, v in compare_grads(g_rep, g_ref).items()})
    return out


def compare_grads(grads, ref) -> dict:
    """Per parameter: max |g - ref| / (GRAD_RTOL |ref| + GRAD_ATOL_FRAC
    max|ref|), which must be <= 1, with g finite and not all zero."""
    out = {}
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(grads[k])
        assert np.isfinite(b).all() and np.abs(b).max() > 0, k
        err = np.abs(b - a) / (GRAD_RTOL * np.abs(a)
                               + GRAD_ATOL_FRAC * np.abs(a).max())
        out[k] = float(err.max())
        assert out[k] <= 1.0, f"{k}: gradient off by {out[k]:.3f} x bound"
    return out
