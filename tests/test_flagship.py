"""The seeded bedroom-class flagship (scene/flagship.py): determinism,
triangle budget, the scene cache, and the native BVH builder it needs."""
import os
import shutil

import numpy as np

from mitsuba3_experiments_tpu.scene import flagship
from mitsuba3_experiments_tpu.scene import native


def _meshes(d):
    return {k: v for k, v in d.items()
            if isinstance(v, dict) and v.get("type") == "mesh"}


def test_bedroom_dict_seed_determinism_and_budget():
    a = _meshes(flagship.bedroom_dict(tri_budget=40_000, seed=3))
    b = _meshes(flagship.bedroom_dict(tri_budget=40_000, seed=3))
    c = _meshes(flagship.bedroom_dict(tri_budget=40_000, seed=4))
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        np.testing.assert_array_equal(a[k]["vertices"], b[k]["vertices"])
        np.testing.assert_array_equal(a[k]["faces"], b[k]["faces"])
    assert any(not np.array_equal(a[k]["vertices"], c[k]["vertices"])
               for k in a)
    n = {k: v["faces"].shape[0] for k, v in a.items()}
    total = sum(n.values()) + 4   # + the two emitter rectangles
    assert abs(total - 40_000) <= 0.1 * 40_000, total
    # the carpet dominates, as in the reference bedroom
    assert n["carpet"] == max(n.values()) and n["carpet"] > 0.5 * total


def test_bedroom_default_budget_table():
    """The literal per-mesh table sums to the 2M-triangle flagship."""
    assert flagship._DEFAULT_BUDGET == 2_000_000
    assert len(flagship._FURNITURE_TRIS) + 1 + len(flagship._SHELL) == 70


def test_scene_cache_default_inside_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert flagship.SCENE_CACHE_DIR == os.path.join(repo, ".scene_cache")
    assert flagship.load_flagship.__defaults__[-1] == flagship.SCENE_CACHE_DIR


def test_scene_cache_key_follows_the_sources(tmp_path, monkeypatch):
    """An edit to a generating source changes the cache key, so a stale
    pickle is never loaded."""
    shutil.copytree(os.path.join(flagship.CHECKOUT, "native"),
                    tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so", "*.tmp.*"))
    monkeypatch.setattr(flagship, "CHECKOUT", str(tmp_path))
    d1 = flagship._source_digest()
    assert flagship._source_digest() == d1
    src = tmp_path / "native" / "sbvh_builder.cpp"
    src.write_text(src.read_text() + "\n// edited\n")
    assert flagship._source_digest() != d1


def test_native_build_and_load():
    path = native.build()
    assert path == native.LIB_PATH and os.path.exists(path)
    assert native.try_build_sbvh_native(
        np.zeros((3, 3), np.float32) + np.eye(3, dtype=np.float32),
        np.array([[0, 1, 2]], np.int32), 8) is not None


def test_load_flagship_cache_roundtrip(tmp_path):
    """A second load comes from the pickle and equals the first build;
    the tree was made by the native spatial-split builder."""
    kw = dict(res=(48, 27), spp=2, tri_budget=20_000, seed=1,
              cache_dir=str(tmp_path))
    s1, m1 = flagship.load_flagship(**kw)
    assert m1["bvh_builder"] == "native-sbvh"
    assert len(list(tmp_path.iterdir())) == 1
    s2, m2 = flagship.load_flagship(**kw)
    assert m2 == m1
    np.testing.assert_array_equal(np.asarray(s2.bvh.unified),
                                  np.asarray(s1.bvh.unified))
    np.testing.assert_array_equal(np.asarray(s2.geometry.faces),
                                  np.asarray(s1.geometry.faces))
    assert s2.bvh.layout == s1.bvh.layout
