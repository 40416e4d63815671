"""Scene compiler: Mitsuba-style nested dicts -> flat device arrays.

JAX-native replacement for mi.load_dict + the C++ scene graph
(/root/reference/path.py:308-330, restirgi.py:591-620).  A scene dict uses the
same vocabulary as Mitsuba's (`type` keys: perspective/rectangle/cube/sphere/
obj/diffuse/conductor/dielectric/twosided/area/ref/...), but compilation
produces a single `Scene` pytree of flat arrays: pre-transformed world-space
triangles, SoA material/emitter tables, an implicit BVH, and a texture atlas.
"""
from __future__ import annotations

import copy

import numpy as np

from ..core import math as cm
from .bvh import build_bvh
from . import mesh as meshlib
from .types import (
    BSDFKind,
    BVH,
    Camera,
    EmitterTable,
    Geometry,
    MaterialTable,
    Scene,
    TextureAtlas,
)
from ..core.distributions import DiscreteDistribution
from ..core.records import BSDFFlags

_BSDF_TYPES = {
    "diffuse", "conductor", "roughconductor", "dielectric", "roughdielectric",
    "plastic", "roughplastic", "mask", "twosided", "null", "principled",
}
_SHAPE_TYPES = {
    "rectangle", "cube", "sphere", "obj", "ply", "mesh", "instance",
    "shapegroup",
}

# conductor presets (eta, k at RGB primaries) — values from standard IOR data
_CONDUCTOR_IOR = {
    "Al": ([1.345, 0.965, 0.617], [7.475, 6.400, 5.303]),
    "Au": ([0.143, 0.375, 1.442], [3.983, 2.386, 1.603]),
    "Cu": ([0.200, 0.924, 1.102], [3.912, 2.448, 2.142]),
    "Ag": ([0.155, 0.116, 0.138], [4.818, 3.123, 2.146]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),  # perfect mirror
}
_DIELECTRIC_IOR = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "glass": 1.5046,
    "bk7": 1.5046, "diamond": 2.419, "polypropylene": 1.49,
}


def _rgb(value, default=(0.5, 0.5, 0.5)):
    if value is None:
        return np.asarray(default, np.float32)
    if isinstance(value, dict):
        if value.get("type") == "rgb":
            return np.asarray(value["value"], np.float32) * np.ones(3, np.float32)
        raise ValueError(f"expected rgb, got {value}")
    arr = np.asarray(value, np.float32)
    return arr * np.ones(3, np.float32)


def _ior(value, default=1.5046):
    if value is None:
        return float(default)
    if isinstance(value, str):
        return float(_DIELECTRIC_IOR[value.lower()])
    return float(value)


class _MaterialBuilder:
    """Accumulates material rows; resolves nesting (twosided/mask) and refs."""

    def __init__(self):
        self.rows: list[dict] = []
        self.named: dict[str, int] = {}
        self.textures: list[np.ndarray] = []

    def _new_row(self):
        self.rows.append(
            dict(
                kind=BSDFKind.DIFFUSE,
                base_color=np.array([0.5, 0.5, 0.5], np.float32),
                params=np.zeros(8, np.float32),
                tex_id=-1,
                flags=BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide,
                twosided=False,
                nested_id=-1,
            )
        )
        return len(self.rows) - 1

    def _texture(self, spec) -> int:
        """Register a bitmap/checkerboard texture; returns atlas index."""
        if isinstance(spec, dict) and spec.get("type") == "bitmap":
            if "data" in spec:
                img = np.asarray(spec["data"], np.float32)
            else:
                from ..utils.image import read_image

                img = read_image(spec["filename"])
            self.textures.append(img.astype(np.float32))
            return len(self.textures) - 1
        if isinstance(spec, dict) and spec.get("type") == "checkerboard":
            c0 = _rgb(spec.get("color0"), (0.4, 0.4, 0.4))
            c1 = _rgb(spec.get("color1"), (0.2, 0.2, 0.2))
            img = np.zeros((2, 2, 3), np.float32)
            img[0, 0] = img[1, 1] = c0
            img[0, 1] = img[1, 0] = c1
            self.textures.append(img)
            return len(self.textures) - 1
        raise ValueError(f"unsupported texture {spec}")

    def _reflectance(self, row: dict, value, default=(0.5, 0.5, 0.5)):
        if isinstance(value, dict) and value.get("type") in ("bitmap", "checkerboard"):
            row["tex_id"] = self._texture(value)
            row["base_color"] = np.ones(3, np.float32)
        else:
            row["base_color"] = _rgb(value, default)

    def build(self, d, name: str | None = None) -> int:
        """Compile one BSDF dict (possibly a ref) -> material row id."""
        if d is None:
            d = {"type": "diffuse"}
        if d.get("type") == "ref":
            return self.named[d["id"]]
        t = d["type"]
        if t == "twosided":
            nested = d.get("bsdf") or d.get("material") or _first_nested_bsdf(d)
            rid = self.build(nested)
            # twosided is an *adapter* in Mitsuba: if the nested BSDF resolved
            # to a shared named row (a ref), copy it into a new row so other
            # shapes using the same name keep their one-sided behavior
            # (in-place mutation flipped every user of the ref).
            if rid in self.named.values():
                self.rows.append(copy.deepcopy(self.rows[rid]))
                rid = len(self.rows) - 1
            self.rows[rid]["twosided"] = True
            self.rows[rid]["flags"] |= BSDFFlags.BackSide
            if name:
                self.named[name] = rid
            return rid

        rid = self._new_row()
        row = self.rows[rid]
        if t == "diffuse":
            row["kind"] = BSDFKind.DIFFUSE
            self._reflectance(row, d.get("reflectance"))
            row["flags"] = BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide
        elif t in ("conductor", "roughconductor"):
            mat = d.get("material", "none" if t == "conductor" else "Al")
            if "eta" in d:
                eta = _rgb(d["eta"]); k = _rgb(d.get("k", 1.0))
            else:
                eta, k = map(np.asarray, _CONDUCTOR_IOR.get(mat, _CONDUCTOR_IOR["none"]))
            row["params"][0:3] = eta
            row["params"][3:6] = k
            self._reflectance(row, d.get("specular_reflectance"), (1, 1, 1))
            if t == "roughconductor":
                row["kind"] = BSDFKind.ROUGH_CONDUCTOR
                row["params"][6] = float(d.get("alpha", 0.1))
                row["flags"] = BSDFFlags.GlossyReflection | BSDFFlags.FrontSide
            else:
                row["kind"] = BSDFKind.CONDUCTOR
                row["flags"] = BSDFFlags.DeltaReflection | BSDFFlags.FrontSide
        elif t in ("dielectric", "roughdielectric", "thindielectric"):
            int_ior = _ior(d.get("int_ior"), 1.5046)
            ext_ior = _ior(d.get("ext_ior"), 1.000277)
            row["params"][0] = int_ior / ext_ior
            self._reflectance(row, d.get("specular_reflectance"), (1, 1, 1))
            if t == "roughdielectric":
                row["kind"] = BSDFKind.ROUGH_DIELECTRIC
                row["params"][6] = float(d.get("alpha", 0.1))
                row["flags"] = (
                    BSDFFlags.GlossyReflection | BSDFFlags.GlossyTransmission
                    | BSDFFlags.FrontSide | BSDFFlags.BackSide
                )
            else:
                row["kind"] = BSDFKind.DIELECTRIC
                row["flags"] = (
                    BSDFFlags.DeltaReflection | BSDFFlags.DeltaTransmission
                    | BSDFFlags.FrontSide | BSDFFlags.BackSide
                )
            row["twosided"] = True  # dielectrics are inherently two-sided
        elif t in ("plastic", "roughplastic"):
            int_ior = _ior(d.get("int_ior"), 1.49)
            ext_ior = _ior(d.get("ext_ior"), 1.000277)
            row["params"][0] = int_ior / ext_ior
            self._reflectance(row, d.get("diffuse_reflectance"), (0.5, 0.5, 0.5))
            if t == "roughplastic":
                row["kind"] = BSDFKind.ROUGH_PLASTIC
                row["params"][6] = float(d.get("alpha", 0.1))
                row["flags"] = (
                    BSDFFlags.GlossyReflection | BSDFFlags.DiffuseReflection
                    | BSDFFlags.FrontSide
                )
            else:
                row["kind"] = BSDFKind.PLASTIC
                row["flags"] = (
                    BSDFFlags.DeltaReflection | BSDFFlags.DiffuseReflection
                    | BSDFFlags.FrontSide
                )
        elif t == "mask":
            nested = d.get("bsdf") or _first_nested_bsdf(d)
            nid = self.build(nested)
            row["kind"] = BSDFKind.MASK
            row["nested_id"] = nid
            self._reflectance(row, d.get("opacity"), (0.5, 0.5, 0.5))
            row["flags"] = self.rows[nid]["flags"] | BSDFFlags.Null
            row["twosided"] = self.rows[nid]["twosided"]
        elif t == "principled":
            row["kind"] = BSDFKind.PRINCIPLED
            self._reflectance(row, d.get("base_color"), (0.5, 0.5, 0.5))
            row["params"][0] = float(d.get("metallic", 0.0))
            row["params"][1] = float(d.get("specular", 0.5))
            rough = float(d.get("roughness", 0.5))
            row["params"][6] = max(rough * rough, 1e-3)
            row["flags"] = (
                BSDFFlags.DiffuseReflection | BSDFFlags.GlossyReflection
                | BSDFFlags.FrontSide
            )
        elif t == "null":
            row["kind"] = BSDFKind.NULL
            row["flags"] = BSDFFlags.Null
            row["twosided"] = True
        else:
            raise ValueError(f"unsupported BSDF type {t}")
        if name:
            self.named[name] = rid
        return rid

    def tables(self) -> tuple[MaterialTable, TextureAtlas]:
        import jax.numpy as jnp

        n = max(len(self.rows), 1)
        if not self.rows:
            self._new_row()
        present = set()
        for r in self.rows:
            present.add(int(r["kind"]))
            if r["nested_id"] >= 0:
                present.add(int(self.rows[r["nested_id"]]["kind"]))
        mt = MaterialTable(
            kind=jnp.asarray([r["kind"] for r in self.rows], jnp.int32),
            base_color=jnp.asarray(
                np.stack([r["base_color"] for r in self.rows]), jnp.float32
            ),
            params=jnp.asarray(
                np.stack([r["params"] for r in self.rows]), jnp.float32
            ),
            tex_id=jnp.asarray([r["tex_id"] for r in self.rows], jnp.int32),
            flags=jnp.asarray([r["flags"] for r in self.rows], jnp.int32),
            twosided=jnp.asarray([r["twosided"] for r in self.rows], bool),
            nested_id=jnp.asarray([r["nested_id"] for r in self.rows], jnp.int32),
            kinds_present=tuple(sorted(present)),
        )
        if self.textures:
            hmax = max(t.shape[0] for t in self.textures)
            wmax = max(t.shape[1] for t in self.textures)
            data = np.zeros((len(self.textures), hmax, wmax, 3), np.float32)
            size = np.zeros((len(self.textures), 2), np.int32)
            for i, tx in enumerate(self.textures):
                data[i, : tx.shape[0], : tx.shape[1]] = tx[..., :3]
                size[i] = tx.shape[:2]
        else:
            data = np.ones((1, 1, 1, 3), np.float32)
            size = np.ones((1, 2), np.int32)
        atlas = TextureAtlas(data=jnp.asarray(data), size=jnp.asarray(size))
        return mt, atlas


def _first_nested_bsdf(d):
    for v in d.values():
        if isinstance(v, dict) and v.get("type") in _BSDF_TYPES | {"ref"}:
            return v
    raise ValueError(f"no nested bsdf in {d}")


def _build_shape_mesh(d) -> meshlib.HostMesh:
    t = d["type"]
    if t == "rectangle":
        m = meshlib.rectangle(subdiv=int(d.get("subdiv", 1)))
    elif t == "cube":
        m = meshlib.cube()
    elif t == "sphere":
        m = meshlib.sphere(
            center=d.get("center", (0, 0, 0)), radius=float(d.get("radius", 1.0))
        )
    elif t in ("obj", "ply"):
        from .obj import load_obj

        m = load_obj(d["filename"], face_normals=bool(d.get("face_normals", False)))
    elif t == "mesh":  # raw arrays
        m = meshlib.HostMesh(
            np.asarray(d["vertices"], np.float32),
            np.asarray(d["faces"], np.int32),
            np.asarray(d["normals"], np.float32) if "normals" in d else None,
            np.asarray(d["uvs"], np.float32) if "uvs" in d else None,
            flat=d.get("normals") is None,
        )
    else:
        raise ValueError(f"unsupported shape type {t}")
    tw = d.get("to_world")
    if tw is not None:
        m = m.transformed(np.asarray(tw, np.float32))
    return m


def _build_camera(d) -> Camera:
    import jax.numpy as jnp

    film = d.get("film", {})
    w = int(film.get("width", 256))
    h = int(film.get("height", 256))
    fov = float(d.get("fov", 45.0))
    axis = d.get("fov_axis", "x")
    tan_half = np.tan(np.deg2rad(fov) / 2)
    aspect = w / h
    if axis == "x" or (axis == "smaller" and w <= h) or (axis == "larger" and w > h):
        tx, ty = tan_half, tan_half / aspect
    else:
        tx, ty = tan_half * aspect, tan_half
    tw = d.get("to_world")
    if tw is None:
        tw = np.eye(4, dtype=np.float32)
    return Camera(
        to_world=jnp.asarray(np.asarray(tw, np.float32)),
        tan_half_fov=jnp.asarray([tx, ty], jnp.float32),
        resolution=(w, h),
    )


def load_dict(scene_dict: dict, bvh_layout=None) -> tuple[Scene, dict]:
    """Compile a scene dict; returns (Scene, meta) where meta carries
    integrator/film/sampler settings (spp, rfilter, max_depth defaults).
    `bvh_layout` (scene/bvh8.BVHLayout) overrides the BVH build/layout
    knobs for this scene; None = bvh8.DEFAULT_LAYOUT."""
    import jax.numpy as jnp

    mb = _MaterialBuilder()
    shapes = []
    camera = None
    meta = {"spp": 16, "rfilter": "box", "integrator": {}}

    # pass 1: named top-level BSDFs (so refs resolve)
    for key, val in scene_dict.items():
        if isinstance(val, dict) and val.get("type") in _BSDF_TYPES:
            mb.build(val, name=key)

    for key, val in scene_dict.items():
        if not isinstance(val, dict) or key == "type":
            continue
        t = val.get("type")
        if t in _BSDF_TYPES:
            continue  # handled
        if t == "perspective":
            camera = _build_camera(val)
            film = val.get("film", {})
            meta["rfilter"] = film.get("rfilter", "box")
            sampler = val.get("sampler", {})
            meta["spp"] = int(sampler.get("sample_count", meta["spp"]))
        elif t in _SHAPE_TYPES:
            shapes.append((key, val))
        elif t in ("path", "direct", "integrator") or key == "integrator":
            meta["integrator"] = dict(val)
        elif t == "constant":
            meta["env_radiance"] = _rgb(val.get("radiance"), (1, 1, 1))
        elif t == "envmap":
            meta["env_radiance"] = _rgb(val.get("scale", 1.0), (1, 1, 1))
            if "data" in val:
                meta["env_map"] = np.asarray(val["data"], np.float32)
            else:
                from ..utils.image import read_image

                meta["env_map"] = read_image(val["filename"])
        # silently skip unknown auxiliary entries

    if camera is None:
        camera = _build_camera({"fov": 45.0})

    # resolve instancing (mi shapegroup/instance, used by the reference's
    # to_dict.py round-trip): shapegroups define geometry, instances stamp a
    # transformed copy — flattened here since geometry is pre-transformed
    groups = {k: v for k, v in shapes if v.get("type") == "shapegroup"}
    resolved = []
    for key, sd in shapes:
        t = sd.get("type")
        if t == "shapegroup":
            continue
        if t == "instance":
            ref = sd.get("shapegroup") or sd.get("ref", {}).get("id")
            if isinstance(ref, dict):
                ref = ref.get("id")
            group = groups[ref]
            for gk, gv in group.items():
                if isinstance(gv, dict) and gv.get("type") in _SHAPE_TYPES:
                    inner = dict(gv)
                    tw_outer = np.asarray(
                        sd.get("to_world", np.eye(4)), np.float32
                    )
                    tw_inner = np.asarray(
                        inner.get("to_world", np.eye(4)), np.float32
                    )
                    inner["to_world"] = tw_outer @ tw_inner
                    resolved.append((f"{key}.{gk}", inner))
        else:
            resolved.append((key, sd))
    shapes = resolved

    # pass 2: shapes -> concatenated geometry
    all_v, all_n, all_uv, all_f = [], [], [], []
    f_mat, f_em, f_shape, f_flat = [], [], [], []
    emitters_rad: list[np.ndarray] = []
    v_off = 0
    for sidx, (key, sd) in enumerate(shapes):
        hm = _build_shape_mesh(sd)
        bsdf_spec = None
        for v in sd.values():
            if isinstance(v, dict) and v.get("type") in _BSDF_TYPES | {"ref"}:
                bsdf_spec = v
                break
        if bsdf_spec is None and isinstance(sd.get("bsdf"), dict):
            raise ValueError(
                f"shape '{key}': unsupported BSDF type "
                f"{sd['bsdf'].get('type')!r}"
            )
        mat_id = mb.build(bsdf_spec)
        em_id = -1
        em = sd.get("emitter")
        if em is None:
            for v in sd.values():
                if isinstance(v, dict) and v.get("type") == "area":
                    em = v
                    break
        if em is not None:
            emitters_rad.append(_rgb(em.get("radiance"), (1, 1, 1)))
            em_id = len(emitters_rad) - 1
        nf = hm.faces.shape[0]
        nv = hm.vertices.shape[0]
        all_v.append(hm.vertices)
        all_n.append(
            hm.normals
            if hm.normals is not None
            else np.zeros((nv, 3), np.float32)
        )
        all_uv.append(
            hm.uvs if hm.uvs is not None else np.zeros((nv, 2), np.float32)
        )
        all_f.append(hm.faces.astype(np.int64) + v_off)
        f_mat.append(np.full(nf, mat_id, np.int32))
        f_em.append(np.full(nf, em_id, np.int32))
        f_shape.append(np.full(nf, sidx, np.int32))
        f_flat.append(np.full(nf, hm.flat or hm.normals is None, bool))
        v_off += nv

    if not shapes:
        raise ValueError("scene has no shapes")

    V = np.concatenate(all_v).astype(np.float32)
    N = np.concatenate(all_n).astype(np.float32)
    UV = np.concatenate(all_uv).astype(np.float32)
    F = np.concatenate(all_f).astype(np.int32)
    face_mat = np.concatenate(f_mat)
    face_em = np.concatenate(f_em)
    face_shape = np.concatenate(f_shape)
    face_flat = np.concatenate(f_flat)

    materials, atlas = mb.tables()
    emitters = _build_emitter_table(
        V, F, face_em, emitters_rad,
        env=meta.pop("env_radiance", None),
        env_map=meta.pop("env_map", None),
    )
    # per-face NEE pdf data (pmf, area) rides the face row so hit shading
    # never needs the (F,)-sized face_to_slot gather
    em_pmf_f = np.zeros(F.shape[0], np.float32)
    em_area_f = np.zeros(F.shape[0], np.float32)
    slot_of = np.asarray(emitters.face_to_slot)
    has_slot = slot_of >= 0
    epk_np = np.asarray(emitters.em_face_packed)
    em_area_f[has_slot] = epk_np[slot_of[has_slot], 9]
    em_pmf_f[has_slot] = epk_np[slot_of[has_slot], 10]
    geometry = Geometry(
        vertices=jnp.asarray(V),
        normals=jnp.asarray(N),
        uvs=jnp.asarray(UV),
        faces=jnp.asarray(F),
        face_mat=jnp.asarray(face_mat),
        face_emitter=jnp.asarray(face_em),
        face_shape=jnp.asarray(face_shape),
        face_flat=jnp.asarray(face_flat),
        face_packed=jnp.asarray(
            _pack_face_rows(V, N, UV, F, face_flat, face_mat, face_em,
                            em_pmf_f, em_area_f)
        ),
    )
    bvh = build_bvh(V, F, layout=bvh_layout, info=meta)
    scene = Scene(
        geometry=geometry,
        materials=materials,
        emitters=emitters,
        camera=camera,
        textures=atlas,
        bvh=bvh,
    )
    return scene, meta




def _pack_face_rows(V, N, UV, F, face_flat, face_mat, face_em,
                    em_pmf=None, em_area=None):
    """One (F, 32) f32 row per face with everything _make_si needs.

    See Geometry.face_packed for the layout rationale (one gather per hit
    instead of 13).  e1/e2 are precomputed with the same
    float subtraction _make_si previously did at runtime, so interactions
    are bit-identical to the 13-gather form.  Cols 27/28 carry the NEE
    pdf data (face pmf, area) copied from EmitterTable so MIS at emitter
    hits reads NO extra large-table rows (pdf_emitter_direction_packed)."""
    nf = F.shape[0]
    pk = np.zeros((nf, 32), np.float32)
    if em_pmf is not None:
        pk[:, 27] = em_pmf
        pk[:, 28] = em_area
    v0 = V[F[:, 0]]
    pk[:, 0:3] = v0
    pk[:, 3:6] = V[F[:, 1]] - v0
    pk[:, 6:9] = V[F[:, 2]] - v0
    pk[:, 9:12] = N[F[:, 0]]
    pk[:, 12:15] = N[F[:, 1]]
    pk[:, 15:18] = N[F[:, 2]]
    pk[:, 18:20] = UV[F[:, 0]]
    pk[:, 20:22] = UV[F[:, 1]]
    pk[:, 22:24] = UV[F[:, 2]]
    pk[:, 24] = face_flat.astype(np.float32)
    pk[:, 25] = face_mat.astype(np.int32).view(np.float32)
    pk[:, 26] = face_em.astype(np.int32).view(np.float32)
    return pk


def _build_emitter_table(V, F, face_em, emitters_rad, env=None,
                         env_map=None) -> EmitterTable:
    import jax.numpy as jnp

    from ..core.distributions import DiscreteDistribution2D

    em_mask = face_em >= 0
    em_faces = np.nonzero(em_mask)[0].astype(np.int32)
    if len(emitters_rad) == 0:
        # no emitters: single zero-radiance dummy so shapes stay static
        rad = np.zeros((1, 3), np.float32)
        em_faces = np.zeros(1, np.int32)
        em_face_emitter = np.zeros(1, np.int32)
        areas = np.ones(1, np.float32)
        weights = np.ones(1, np.float32)  # f32: packed prob must bit-match
        face_to_slot = np.full(F.shape[0], -1, np.int32)
    else:
        rad = np.stack(emitters_rad).astype(np.float32)
        em_face_emitter = face_em[em_faces]
        areas = meshlib.face_areas(V, F[em_faces])
        power = (
            rad[em_face_emitter, 0] * 0.212671
            + rad[em_face_emitter, 1] * 0.715160
            + rad[em_face_emitter, 2] * 0.072169
        )
        weights = np.maximum(areas * power, 1e-12).astype(np.float32)
        face_to_slot = np.full(F.shape[0], -1, np.int32)
        face_to_slot[em_faces] = np.arange(len(em_faces), dtype=np.int32)

    # environment: luminance * sin(theta) importance table
    if env_map is None:
        env_map = np.ones((1, 1, 3), np.float32)
    env_scale = np.zeros(3, np.float32) if env is None else np.asarray(env)
    he, we = env_map.shape[:2]
    lum = (
        env_map[..., 0] * 0.212671 + env_map[..., 1] * 0.71516
        + env_map[..., 2] * 0.072169
    )
    sin_t = np.sin((np.arange(he) + 0.5) / he * np.pi)[:, None]
    env_weights = np.maximum(lum * sin_t, 1e-12).astype(np.float32)
    # NEE selection probability: env power vs area-light power (host
    # heuristic).  Only *textured* envmaps participate in NEE; the constant
    # emitter stays BSDF-sampled-only (pdf 0 -> escape MIS weight 1), which
    # keeps the furnace estimator exact.
    p_env = 0.0
    if env is not None and (he, we) != (1, 1):
        env_power = float(env_scale.mean()) * float(lum.mean()) * 4 * np.pi
        area_power = (
            0.0 if len(emitters_rad) == 0 else float(np.sum(weights)) * np.pi
        )
        p_env = env_power / max(env_power + area_power, 1e-12)
        p_env = float(np.clip(
            p_env, 0.1, 1.0 if len(emitters_rad) == 0 else 0.9
        ))

    face_dist = DiscreteDistribution.create(jnp.asarray(weights))
    # em_face_packed: see EmitterTable for layout.  prob/cdf copy the
    # device distribution's own arrays so packed sampling is bit-identical
    # to the take()-based form it replaces.
    cdf = np.asarray(face_dist.cdf)
    total = np.asarray(face_dist.total, np.float32)
    v0 = V[F[em_faces, 0]]
    epk = np.zeros((len(em_faces), 16), np.float32)
    epk[:, 0:3] = v0
    epk[:, 3:6] = V[F[em_faces, 1]] - v0
    epk[:, 6:9] = V[F[em_faces, 2]] - v0
    epk[:, 9] = areas
    epk[:, 10] = weights / total
    epk[:, 11] = np.concatenate([[np.float32(0.0)], cdf[:-1]])
    epk[:, 12] = cdf
    epk[:, 13] = em_face_emitter.astype(np.int32).view(np.float32)

    return EmitterTable(
        env_radiance=jnp.asarray(env_scale),
        env_map=jnp.asarray(env_map.astype(np.float32)),
        env_dist=DiscreteDistribution2D.create(jnp.asarray(env_weights)),
        env_select_p=jnp.asarray(p_env, jnp.float32),
        radiance=jnp.asarray(rad),
        em_face=jnp.asarray(em_faces),
        em_face_emitter=jnp.asarray(em_face_emitter),
        em_face_area=jnp.asarray(areas),
        face_dist=face_dist,
        face_to_slot=jnp.asarray(face_to_slot),
        em_face_packed=jnp.asarray(epk),
    )
