"""Flagship benchmark scene: a seeded bedroom-class interior.

The reference's north-star scene is a bedroom (BASELINE.md: 1280x720,
spp 64, max_depth 65, tent filter; SURVEY.md: 72 shapes = 70 meshes + 2
rectangle area emitters, a diffuse/conductor/dielectric/rough/mask/twosided
BSDF mix, 4 textures, ~2M triangles of which the carpet is most).  Its mesh
and texture bytes are not distributed with the reference, so this module
generates a scene with those facts.  Every structural value is a literal
below; only the geometry's placement and shape noise come from `seed`.

  * 70 meshes: the carpet (a finely tessellated pile heightfield), 63
    furniture pieces (displaced-sphere blobs) and a 6-piece room shell;
  * 2 rectangle area emitters: a ceiling panel and a window;
  * 64 named BSDFs (`_BSDF_MIX`), 4 of them checkerboard-textured;
  * the camera at (3.456, 1.212, 3.299) looking into the room, fov 60 (x);
  * per-mesh triangle budgets from `_CARPET_TRIS` and `_FURNITURE_TRIS`
    (2M in total at the default budget, scaled linearly for others).
"""
from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np

from ..core import math as cm
from .mesh import HostMesh, rectangle, sphere

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENE_CACHE_DIR = os.path.join(CHECKOUT, ".scene_cache")

CAMERA_ORIGIN = (3.456, 1.212, 3.299)
CAMERA_TARGET = (-0.5, 0.85, -0.4)
CAMERA_FOV = 60.0
MAX_DEPTH = 65

# the room shell encloses the camera; furniture stays in the inner box
_ROOM_LO = np.array([-3.6, -0.05, -3.6], np.float32)
_ROOM_HI = np.array([4.6, 3.0, 4.6], np.float32)
_BLOB_LO = np.array([-2.5, 0.0, -2.5], np.float32)
_BLOB_HI = np.array([2.3, 2.4, 2.3], np.float32)
_CARPET_LO = (-2.2, -2.2)       # (x, z) extent of the carpet
_CARPET_HI = (2.8, 2.8)
_SHELL_SUBDIV = 16              # 512 triangles per shell piece

# triangle budgets at the default 2M total (the shell's 6 x 512 are fixed)
_CARPET_TRIS = 1_500_000
_FURNITURE_TRIS = (
    72_000, 52_000, 36_000, 27_000, 22_000, 18_000, 16_000, 14_000,
    12_000, 12_000, 11_000, 10_000, 10_000, 9_000, 9_000, 8_000,
    8_000, 8_000, 7_000, 7_000, 7_000, 6_000, 6_000, 6_000,
    6_000, 5_000, 5_000, 5_000, 5_000, 4_500, 4_500, 4_000,
    4_000, 4_000, 4_000, 3_500, 3_500, 3_500, 3_000, 3_000,
    3_000, 3_000, 2_500, 2_500, 2_500, 2_000, 2_000, 2_000,
    2_000, 1_800, 1_600, 1_500, 1_400, 1_200, 1_100, 1_000,
    1_000, 900, 800, 700, 600, 500, 828,
)
_SHELL = ("floor", "ceiling", "wall_zlo", "wall_zhi", "wall_xlo", "wall_xhi")
_DEFAULT_BUDGET = (_CARPET_TRIS + sum(_FURNITURE_TRIS)
                   + len(_SHELL) * 2 * _SHELL_SUBDIV ** 2)

_PALETTE = (
    (0.72, 0.66, 0.58), (0.45, 0.32, 0.22), (0.80, 0.80, 0.78),
    (0.30, 0.36, 0.45), (0.55, 0.20, 0.18), (0.25, 0.40, 0.28),
    (0.62, 0.55, 0.40), (0.15, 0.14, 0.13),
)
_CHECKERS = (
    ((0.50, 0.45, 0.40), (0.30, 0.28, 0.25)),
    ((0.60, 0.58, 0.55), (0.20, 0.22, 0.30)),
    ((0.70, 0.50, 0.30), (0.40, 0.25, 0.15)),
    ((0.85, 0.85, 0.80), (0.55, 0.50, 0.45)),
)
# (kind, count): the 64-BSDF mix; the 2 plain diffuse rows back the emitters
_BSDF_MIX = (
    ("twosided_diffuse", 32), ("textured", 4), ("roughplastic", 10),
    ("roughconductor", 6), ("conductor", 3), ("dielectric", 4),
    ("mask", 3), ("diffuse", 2),
)
_EMITTERS = {
    # name: (center, rotation (axis, degrees), half extents, radiance)
    "light_ceiling": ((0.5, 2.95, 0.5), ((1, 0, 0), 90), (0.6, 0.6),
                      (18.0, 16.0, 13.0)),
    "light_window": ((-3.55, 1.6, 0.2), ((0, 1, 0), 90), (1.0, 0.7),
                     (8.0, 9.0, 11.0)),
}


def _bsdf(kind: str, i: int) -> dict:
    col = list(_PALETTE[i % len(_PALETTE)])
    if kind == "twosided_diffuse":
        return {"type": "twosided",
                "bsdf": {"type": "diffuse", "reflectance": col}}
    if kind == "textured":
        c0, c1 = _CHECKERS[i % len(_CHECKERS)]
        return {"type": "twosided", "bsdf": {
            "type": "diffuse", "reflectance": {
                "type": "checkerboard", "color0": list(c0),
                "color1": list(c1)}}}
    if kind == "roughplastic":
        return {"type": "roughplastic", "diffuse_reflectance": col,
                "alpha": (0.05, 0.1, 0.2, 0.3)[i % 4], "int_ior": 1.49}
    if kind == "roughconductor":
        return {"type": "roughconductor",
                "material": ("Al", "Cu", "Au", "Ag")[i % 4],
                "alpha": (0.05, 0.15, 0.3)[i % 3]}
    if kind == "conductor":
        return {"type": "conductor", "material": ("Al", "Ag", "none")[i % 3]}
    if kind == "dielectric":
        return {"type": "dielectric", "int_ior": 1.5046,
                "ext_ior": 1.000277}
    if kind == "mask":
        return {"type": "mask", "opacity": 0.6,
                "bsdf": {"type": "twosided", "bsdf": {
                    "type": "diffuse", "reflectance": col}}}
    if kind == "diffuse":
        return {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]}
    raise ValueError(kind)


def bedroom_bsdfs() -> dict:
    """The 64 named BSDFs, in `_BSDF_MIX` order."""
    out = {}
    for kind, count in _BSDF_MIX:
        for i in range(count):
            out[f"bsdf_{kind}_{i}"] = _bsdf(kind, i)
    return out


def placeholder_mesh(seed, n_tris: int) -> HostMesh:
    """A displaced-sphere blob of ~n_tris triangles inside the furniture
    box, drawn from `seed`."""
    n_theta = max(4, int(np.sqrt(max(n_tris, 64) / 4)))
    base = sphere(radius=1.0, n_theta=n_theta, n_phi=2 * n_theta)
    rng = np.random.default_rng(seed)
    # a few random low-frequency radial lobes -> blobby furniture
    v = base.vertices
    disp = np.zeros(len(v), np.float32)
    for _ in range(6):
        d = rng.normal(size=3).astype(np.float32)
        d /= np.linalg.norm(d)
        disp += 0.15 * np.cos(3.0 * (v @ d) + rng.uniform(0, 6.28)).astype(
            np.float32
        )
    v = v * (1.0 + disp[:, None] * 0.5)
    scale = 0.12 + 0.45 * rng.random(3).astype(np.float32)
    pos = _BLOB_LO + (0.1 + 0.8 * rng.random(3).astype(np.float32)) * (
        _BLOB_HI - _BLOB_LO
    )
    return HostMesh((v * scale + pos).astype(np.float32), base.faces, None,
                    base.uvs, flat=True)


def carpet_mesh(seed, n_tris: int) -> HostMesh:
    """A floor-level pile heightfield of ~n_tris triangles."""
    n = max(2, int(np.sqrt(n_tris / 2)))
    rng = np.random.default_rng(seed)
    x = np.linspace(_CARPET_LO[0], _CARPET_HI[0], n + 1, dtype=np.float32)
    z = np.linspace(_CARPET_LO[1], _CARPET_HI[1], n + 1, dtype=np.float32)
    xx, zz = np.meshgrid(x, z, indexing="ij")
    yy = 0.005 + 0.004 * rng.random(xx.shape, dtype=np.float32)
    v = np.stack([xx, yy, zz], -1).reshape(-1, 3)
    uv = np.stack(np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1),
                              indexing="ij"), -1).reshape(-1, 2)
    i = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    a, b, c, d = i, i + 1, i + n + 1, i + n + 2
    # wound so the geometric normal faces +y
    f = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
    return HostMesh(v, f.reshape(-1, 3).astype(np.int32),
                    None, uv.astype(np.float32), flat=True)


def _shell_transforms() -> dict:
    lo, hi = _ROOM_LO, _ROOM_HI
    cx, cy, cz = (lo + hi) / 2
    sx, sy, sz = (hi - lo) / 2
    T = cm.matmul4
    return {
        "floor": T(cm.translate([cx, lo[1], cz]), cm.rotate([1, 0, 0], -90),
                   cm.scale_mat([sx, sz, 1])),
        "ceiling": T(cm.translate([cx, hi[1], cz]), cm.rotate([1, 0, 0], 90),
                     cm.scale_mat([sx, sz, 1])),
        "wall_zlo": T(cm.translate([cx, cy, lo[2]]),
                      cm.scale_mat([sx, sy, 1])),
        "wall_zhi": T(cm.translate([cx, cy, hi[2]]),
                      cm.rotate([0, 1, 0], 180), cm.scale_mat([sx, sy, 1])),
        "wall_xlo": T(cm.translate([lo[0], cy, cz]),
                      cm.rotate([0, 1, 0], 90), cm.scale_mat([sz, sy, 1])),
        "wall_xhi": T(cm.translate([hi[0], cy, cz]),
                      cm.rotate([0, 1, 0], -90), cm.scale_mat([sz, sy, 1])),
    }


def _mesh_entry(hm: HostMesh, bsdf_id: str) -> dict:
    return {"type": "mesh", "vertices": hm.vertices, "faces": hm.faces,
            "uvs": hm.uvs, "bsdf": {"type": "ref", "id": bsdf_id}}


def bedroom_dict(res=(1280, 720), spp: int = 64,
                 tri_budget: int = 2_000_000, seed: int = 0) -> dict:
    """The flagship scene dict (build.load_dict vocabulary)."""
    d: dict = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": MAX_DEPTH},
        "sensor": {
            "type": "perspective", "fov": CAMERA_FOV, "fov_axis": "x",
            "to_world": cm.look_at(CAMERA_ORIGIN, CAMERA_TARGET, [0, 1, 0]),
            "sampler": {"type": "independent", "sample_count": spp},
            "film": {"type": "hdrfilm", "width": res[0], "height": res[1],
                     "rfilter": "tent"},
        },
    }
    bsdfs = bedroom_bsdfs()
    d.update(bsdfs)
    surface = [k for k in bsdfs if not k.startswith("bsdf_diffuse_")]
    emitter_bsdfs = [k for k in bsdfs if k.startswith("bsdf_diffuse_")]

    shell_tris = len(_SHELL) * 2 * _SHELL_SUBDIV ** 2
    scale = max(tri_budget - shell_tris, 0) / (_DEFAULT_BUDGET - shell_tris)
    d["carpet"] = _mesh_entry(
        carpet_mesh([seed, 0], int(_CARPET_TRIS * scale)),
        "bsdf_textured_0")
    for k, n in enumerate(_FURNITURE_TRIS):
        d[f"furniture_{k:02d}"] = _mesh_entry(
            placeholder_mesh([seed, k + 1], int(n * scale)),
            surface[k % len(surface)])
    for name, tw in _shell_transforms().items():
        hm = rectangle(subdiv=_SHELL_SUBDIV).transformed(tw)
        d[f"shell_{name}"] = _mesh_entry(
            hm, "bsdf_twosided_diffuse_0" if name == "floor"
            else "bsdf_twosided_diffuse_2")
    for (name, (c, (axis, deg), (hx, hy), rad)), bid in zip(
            _EMITTERS.items(), emitter_bsdfs):
        d[name] = {
            "type": "rectangle",
            "to_world": cm.matmul4(cm.translate(list(c)),
                                   cm.rotate(list(axis), deg),
                                   cm.scale_mat([hx, hy, 1])),
            "bsdf": {"type": "ref", "id": bid},
            "emitter": {"type": "area", "radiance": list(rad)},
        }
    return d


def _source_digest() -> str:
    """Digest of the code that generates and compiles the scene: the scene
    package, core/math.py and the native builder's sources."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene_dir = os.path.join(pkg, "scene")
    native_dir = os.path.join(CHECKOUT, "native")
    paths = sorted(
        [os.path.join(scene_dir, f) for f in os.listdir(scene_dir)
         if f.endswith(".py")]
        + [os.path.join(native_dir, f) for f in os.listdir(native_dir)
           if f.endswith(".cpp") or f == "Makefile"]
        + [os.path.join(pkg, "core", "math.py")])
    h = hashlib.sha1()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.relpath(p, CHECKOUT).encode() + f.read())
    return h.hexdigest()[:12]


def load_flagship(res=(1280, 720), spp: int = 64, tri_budget: int = 2_000_000,
                  seed: int = 0, cache_dir: str | None = SCENE_CACHE_DIR):
    """Compile the flagship scene with the native BVH builder (built on
    first use).  Results are pickled under `cache_dir` (default: the
    checkout's .scene_cache/), keyed by the arguments and a digest of the
    generating sources; None disables the cache."""
    import jax

    from . import native
    from .build import load_dict

    native.build()
    key = (f"bedroom_{res[0]}x{res[1]}_spp{spp}_t{tri_budget}_s{seed}_"
           f"{_source_digest()}")
    path = None if not cache_dir else os.path.join(cache_dir, key + ".pkl")
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            host = pickle.load(f)
        return jax.tree_util.tree_map(jax.numpy.asarray, host["scene"]), \
            host["meta"]
    scene, meta = load_dict(bedroom_dict(res, spp, tri_budget, seed))
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"scene": jax.tree_util.tree_map(np.asarray, scene),
                         "meta": meta}, f)
        os.replace(tmp, path)
    return scene, meta
