"""BSDF unit tests: sample/eval/pdf mutual consistency, energy conservation,
sampled-density histograms vs pdf (the chi^2-style strategy SURVEY.md section 4
prescribes for the new framework)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba3_experiments_tpu.core import math as m
from mitsuba3_experiments_tpu.core import rng, warp
from mitsuba3_experiments_tpu.core.records import SurfaceInteraction
from mitsuba3_experiments_tpu.render import bsdf as bsdflib
from mitsuba3_experiments_tpu.scene import load_dict
from mitsuba3_experiments_tpu.scene.cornell import cornell_box


def _scene_with(bsdf_dict):
    d = {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45.0},
        "s": {"type": "rectangle", "bsdf": bsdf_dict},
    }
    return load_dict(d)[0]


def _si_with_wi(n, wi, mat_id=0):
    si = SurfaceInteraction.invalid(n)
    wi = jnp.broadcast_to(jnp.asarray(wi, jnp.float32), (n, 3))
    return dataclasses.replace(
        si,
        wi=m.normalize(wi),
        mat_id=jnp.full((n,), mat_id, jnp.int32),
        t=jnp.ones((n,), jnp.float32),
    )


def _draw(scene, si, n, seed=3):
    s = rng.Sampler.create(seed, n)
    s, u1 = s.next_1d()
    s, u2 = s.next_2d()
    bs, w = bsdflib.sample(scene.materials, scene.textures, si, u1, u2)
    return bs, w


N = 1 << 15


def test_diffuse_sample_weight_and_consistency():
    albedo = [0.7, 0.5, 0.3]
    scene = _scene_with({"type": "diffuse", "reflectance": albedo})
    si = _si_with_wi(N, [0.3, 0.1, 0.8])
    bs, w = _draw(scene, si, N)
    # cosine sampling of a diffuse BRDF: weight == albedo exactly
    np.testing.assert_allclose(np.asarray(w).mean(0), albedo, atol=1e-3)
    # eval/pdf at the sampled directions reproduce the weight
    f, pdf = bsdflib.eval_pdf(scene.materials, scene.textures, si, bs.wo)
    np.testing.assert_allclose(np.asarray(pdf), np.asarray(bs.pdf), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(f) / np.asarray(pdf)[:, None], np.asarray(w), rtol=1e-4
    )
    # backside gives nothing (one-sided)
    si_back = _si_with_wi(16, [0.0, 0.0, -1.0])
    bs_b, w_b = _draw(scene, si_back, 16)
    assert float(jnp.max(w_b)) == 0.0


def test_diffuse_twosided():
    scene = _scene_with(
        {"type": "twosided", "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]}}
    )
    si_back = _si_with_wi(N, [0.1, -0.2, -0.9])
    bs, w = _draw(scene, si_back, N)
    np.testing.assert_allclose(np.asarray(w).mean(0), 0.6, atol=1e-3)
    # sampled directions flipped into the back hemisphere
    assert float(jnp.mean(bs.wo[:, 2] < 0)) > 0.999


def test_twosided_ref_does_not_mutate_shared_bsdf():
    """twosided over a ref must copy the named row, not flip it in place
    (ADVICE round 1: shapes sharing the named BSDF silently became
    two-sided)."""
    d = {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45.0},
        "shared_mat": {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]},
        "a": {"type": "rectangle", "bsdf": {"type": "ref", "id": "shared_mat"}},
        "b": {
            "type": "rectangle",
            "bsdf": {"type": "twosided", "bsdf": {"type": "ref", "id": "shared_mat"}},
        },
    }
    scene = load_dict(d)[0]
    two = np.asarray(scene.materials.twosided)
    # two distinct rows: the shared one stays one-sided
    assert two.sum() == 1, two
    # shape "a" still references the one-sided row
    mats = np.asarray(scene.geometry.face_mat)
    assert not two[mats[0]]


def _density_check(scene, wi, atol=0.02):
    """Histogram of sampled cos-theta bins vs MC integral of pdf per bin."""
    si = _si_with_wi(N, wi)
    bs, w = _draw(scene, si, N)
    wo = np.asarray(bs.wo)
    pdfs = np.asarray(bs.pdf)
    keep = pdfs > 0
    wo = wo[keep]

    # quadrature: uniform sphere samples, pdf evaluated there
    u = rng.Sampler.create(11, N).next_2d()[1]
    q = warp.square_to_uniform_sphere(u)
    _, pdf_q = bsdflib.eval_pdf(scene.materials, scene.textures, si, q)
    pdf_q = np.asarray(pdf_q)

    bins = np.linspace(-1, 1, 17)
    hist_s, _ = np.histogram(wo[:, 2], bins=bins)
    frac_sampled = hist_s / max(len(wo), 1)
    # integral of pdf over each bin (4pi * mean of pdf restricted to bin)
    zq = np.asarray(q[:, 2])
    frac_pdf = np.array(
        [
            pdf_q[(zq >= lo) & (zq < hi)].sum() * 4 * np.pi / len(zq)
            for lo, hi in zip(bins[:-1], bins[1:])
        ]
    )
    frac_pdf /= max(frac_pdf.sum(), 1e-9)
    np.testing.assert_allclose(frac_sampled, frac_pdf, atol=atol)


def test_rough_conductor_density_and_energy():
    scene = _scene_with(
        {"type": "roughconductor", "material": "none", "alpha": 0.3}
    )
    _density_check(scene, [0.4, 0.0, 0.7])
    si = _si_with_wi(N, [0.4, 0.0, 0.7])
    bs, w = _draw(scene, si, N)
    e = float(jnp.mean(m.luminance(w)))
    # single-scattering GGX with F=1 loses some energy but conserves it
    assert 0.75 < e <= 1.02, e
    # consistency: weight == eval/pdf at sampled dirs
    f, pdf = bsdflib.eval_pdf(scene.materials, scene.textures, si, bs.wo)
    keep = np.asarray(bs.pdf) > 1e-5
    np.testing.assert_allclose(
        (np.asarray(f)[keep] / np.asarray(pdf)[keep][:, None]),
        np.asarray(w)[keep],
        rtol=2e-2, atol=1e-3,
    )


def test_smooth_conductor_mirror():
    scene = _scene_with({"type": "conductor", "material": "none"})
    si = _si_with_wi(8, [0.3, -0.2, 0.93])
    bs, w = _draw(scene, si, 8)
    wo = np.asarray(bs.wo)
    wi = np.asarray(si.wi)
    np.testing.assert_allclose(wo[:, :2], -wi[:, :2], atol=1e-5)
    np.testing.assert_allclose(wo[:, 2], wi[:, 2], atol=1e-5)
    np.testing.assert_allclose(np.asarray(w), 1.0, atol=1e-5)  # F=1 mirror
    # delta lobe: eval returns 0
    f, pdf = bsdflib.eval_pdf(scene.materials, scene.textures, si, bs.wo)
    assert float(jnp.max(jnp.abs(f))) == 0.0


def test_dielectric_snell_and_energy():
    eta = 1.5
    scene = _scene_with({"type": "dielectric", "int_ior": eta, "ext_ior": 1.0})
    si = _si_with_wi(N, [0.5, 0.0, 0.866])
    bs, w = _draw(scene, si, N)
    wo = np.asarray(bs.wo)
    refracted = wo[:, 2] < 0
    assert refracted.any() and (~refracted).any()
    # Snell: sin_t = sin_i / eta
    sin_i = np.linalg.norm(np.asarray(si.wi)[0, :2])
    sin_t = np.linalg.norm(wo[refracted][:, :2], axis=1)
    np.testing.assert_allclose(sin_t, sin_i / eta, atol=1e-5)
    # unit output dirs
    np.testing.assert_allclose(np.linalg.norm(wo, axis=1), 1.0, atol=1e-5)
    # energy: radiance scaling 1/eta^2 on refraction, 1 on reflection;
    # the *power* balance E[w * (eta_out^2)] == 1 for lossless interface
    eta_out = np.asarray(bs.eta)
    np.testing.assert_allclose(
        (np.asarray(w)[:, 0] * eta_out**2).mean(), 1.0, atol=5e-3
    )


def test_dielectric_tir():
    # from inside at grazing angle: total internal reflection
    scene = _scene_with({"type": "dielectric", "int_ior": 1.5, "ext_ior": 1.0})
    si = _si_with_wi(64, [0.9, 0.0, -0.436])  # sin_i = 0.9 > 1/1.5
    bs, w = _draw(scene, si, 64)
    wo = np.asarray(bs.wo)
    assert (wo[:, 2] < 0).all()  # all reflected back inside
    np.testing.assert_allclose(np.asarray(w), 1.0, atol=1e-5)


def test_rough_dielectric_consistency():
    scene = _scene_with(
        {"type": "roughdielectric", "int_ior": 1.5, "alpha": 0.2}
    )
    si = _si_with_wi(N, [0.3, 0.2, 0.93])
    bs, w = _draw(scene, si, N)
    keep = np.asarray(bs.pdf) > 1e-4
    f, pdf = bsdflib.eval_pdf(scene.materials, scene.textures, si, bs.wo)
    np.testing.assert_allclose(
        np.asarray(f)[keep] / np.asarray(pdf)[keep][:, None],
        np.asarray(w)[keep],
        rtol=5e-2, atol=2e-3,
    )
    e = float(np.mean(np.asarray(w)[:, 0] * np.asarray(bs.eta) ** 2))
    assert 0.75 < e < 1.05, e


def test_plastic_energy_below_one():
    scene = _scene_with(
        {"type": "plastic", "diffuse_reflectance": [0.8, 0.8, 0.8]}
    )
    si = _si_with_wi(N, [0.2, 0.1, 0.95])
    bs, w = _draw(scene, si, N)
    e = float(jnp.mean(m.luminance(w)))
    assert 0.5 < e < 1.0, e


def test_rough_plastic_consistency():
    scene = _scene_with(
        {"type": "roughplastic", "diffuse_reflectance": [0.5, 0.5, 0.5], "alpha": 0.3}
    )
    _density_check(scene, [0.2, -0.1, 0.95], atol=0.03)
    si = _si_with_wi(N, [0.2, -0.1, 0.95])
    bs, w = _draw(scene, si, N)
    f, pdf = bsdflib.eval_pdf(scene.materials, scene.textures, si, bs.wo)
    keep = np.asarray(bs.pdf) > 1e-4
    np.testing.assert_allclose(
        np.asarray(f)[keep] / np.asarray(pdf)[keep][:, None],
        np.asarray(w)[keep],
        rtol=5e-2, atol=2e-3,
    )


def test_mask_pass_through_energy():
    scene = _scene_with(
        {
            "type": "mask",
            "opacity": [0.3, 0.3, 0.3],
            "bsdf": {"type": "diffuse", "reflectance": [1.0, 1.0, 1.0]},
        }
    )
    si = _si_with_wi(N, [0.1, 0.0, 0.99])
    bs, w = _draw(scene, si, N)
    wo = np.asarray(bs.wo)
    through = wo[:, 2] < 0
    # ~70% pass straight through
    assert abs(through.mean() - 0.7) < 0.02
    # energy: E[w] = opacity * 1 + (1-opacity) * 1 = 1
    np.testing.assert_allclose(np.asarray(w).mean(0), 1.0, atol=0.02)
    # pass-through is exactly -wi
    np.testing.assert_allclose(
        wo[through], -np.asarray(si.wi)[through], atol=1e-6
    )


def test_texture_modulates_albedo():
    scene = _scene_with(
        {
            "type": "diffuse",
            "reflectance": {
                "type": "bitmap",
                "data": np.full((4, 4, 3), 0.25, np.float32),
            },
        }
    )
    si = _si_with_wi(128, [0.0, 0.0, 1.0])
    bs, w = _draw(scene, si, 128)
    np.testing.assert_allclose(np.asarray(w), 0.25, atol=1e-5)


def test_principled_consistency_and_energy():
    for metallic in (0.0, 1.0):
        scene = _scene_with(
            {"type": "principled", "base_color": [0.8, 0.6, 0.4],
             "metallic": metallic, "roughness": 0.4, "specular": 0.5}
        )
        si = _si_with_wi(N, [0.3, 0.1, 0.9])
        bs, w = _draw(scene, si, N)
        e = float(jnp.mean(m.luminance(w)))
        assert 0.2 < e <= 1.05, (metallic, e)
        f, pdf = bsdflib.eval_pdf(scene.materials, scene.textures, si, bs.wo)
        keep = np.asarray(bs.pdf) > 1e-4
        np.testing.assert_allclose(
            np.asarray(f)[keep] / np.asarray(pdf)[keep][:, None],
            np.asarray(w)[keep],
            rtol=5e-2, atol=2e-3,
        )
    _density_check(scene, [0.3, 0.1, 0.9], atol=0.03)
