"""Flat device scene representation.

The Mitsuba C++ scene graph (shapes, BSDF/emitter plugin instances, OptiX
geometry — see SURVEY.md section 2.2) becomes a handful of flat arrays: XLA-
friendly structure-of-arrays tables indexed by per-lane integer ids, with
polymorphism resolved by masked multiplexing over the `kind` column instead of
vcalls (/root/reference/patch.py:14-44's dr.dispatch has no XLA analog).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.distributions import DiscreteDistribution, DiscreteDistribution2D
from ..core.struct import jstruct, static_field


# BSDF kinds (material table `kind` column).
class BSDFKind:
    DIFFUSE = 0
    CONDUCTOR = 1
    ROUGH_CONDUCTOR = 2
    DIELECTRIC = 3
    ROUGH_DIELECTRIC = 4
    PLASTIC = 5
    ROUGH_PLASTIC = 6
    MASK = 7
    NULL = 8
    PRINCIPLED = 9

    COUNT = 10


@jstruct
class Geometry:
    """Indexed triangle soup with per-face material/emitter binding."""

    vertices: jnp.ndarray      # (V, 3) f32, world space (pre-transformed)
    normals: jnp.ndarray       # (V, 3) f32 vertex shading normals
    uvs: jnp.ndarray           # (V, 2) f32
    faces: jnp.ndarray         # (F, 3) i32
    face_mat: jnp.ndarray      # (F,) i32 material row
    face_emitter: jnp.ndarray  # (F,) i32 emitter row or -1
    face_shape: jnp.ndarray    # (F,) i32 source shape index
    face_flat: jnp.ndarray     # (F,) bool: use geometric normal for shading
    # Packed per-face shading row, ONE gather per hit instead of 13 (the
    # design assumes _make_si's cost is its gather COUNT — a hypothesis on
    # the GPU, ROADMAP queue 1, item 3).
    # Layout (F, 32) f32: v0[0:3] e1[3:6] e2[6:9] n0[9:12] n1[12:15]
    # n2[15:18] uv0[18:20] uv1[20:22] uv2[22:24] flat[24]
    # mat_id[25] emitter_id[26] (i32 bitcast) em_pmf[27] em_area[28]
    # pad[29:32] — em_* mirror EmitterTable so NEE-pdf at emitter hits
    # needs no face_to_slot/em_face_packed gathers (round-3 fold)
    face_packed: jnp.ndarray   # (F, 32) f32


@jstruct
class MaterialTable:
    """One row per BSDF instance.

    param layout by kind (columns of `params`):
      DIFFUSE:          base_color = reflectance
      CONDUCTOR:        params[0:3] = eta, params[3:6] = k, base_color = tint
      ROUGH_CONDUCTOR:  + params[6] = alpha
      DIELECTRIC:       params[0] = int_ior / ext_ior (relative eta)
      ROUGH_DIELECTRIC: + params[6] = alpha
      PLASTIC:          base_color = diffuse refl., params[0] = eta,
                        params[1] = internal Fresnel diffuse reflectance
      ROUGH_PLASTIC:    + params[6] = alpha
      MASK:             base_color = opacity, nested_id = wrapped BSDF row
      PRINCIPLED:       base_color, params[0] = metallic, params[1] =
                        specular, params[6] = alpha (= roughness^2)
    """

    kind: jnp.ndarray        # (M,) i32 BSDFKind
    base_color: jnp.ndarray  # (M, 3) f32
    params: jnp.ndarray      # (M, 8) f32
    tex_id: jnp.ndarray      # (M,) i32 bitmap texture for base_color, -1 none
    flags: jnp.ndarray       # (M,) i32 BSDFFlags union of lobes
    twosided: jnp.ndarray    # (M,) bool
    nested_id: jnp.ndarray   # (M,) i32 (MASK wrapper), -1 none
    # static: sorted tuple of BSDFKind values that actually occur (incl.
    # MASK-nested kinds).  Lets the dispatch skip absent lobe families at
    # trace time — smaller XLA program, less elementwise work.  () = unknown = all.
    kinds_present: tuple = static_field(default=())


@jstruct
class TextureAtlas:
    """Stacked bitmap textures padded to a common resolution."""

    data: jnp.ndarray   # (T, Hmax, Wmax, 3) f32
    size: jnp.ndarray   # (T, 2) i32 actual (h, w)


@jstruct
class EmitterTable:
    """Area emitters flattened to the set of emissive faces.

    NEE samples a face from a *power-weighted* global distribution over all
    emissive faces, then a uniform point on that face.  (Mitsuba picks an
    emitter uniformly, then area-samples the shape; the power weighting is
    the better importance sampler and stays unbiased — pdfs are consistent
    between sample_direction and pdf_direction below.)
    """

    radiance: jnp.ndarray         # (E, 3) f32 per emitter
    em_face: jnp.ndarray          # (EF,) i32 emissive face ids
    em_face_emitter: jnp.ndarray  # (EF,) i32 emitter row per emissive face
    em_face_area: jnp.ndarray     # (EF,) f32 world-space area
    # Packed per-emissive-face row: NEE sampling needs ONE gather after the
    # CDF search instead of a 4-deep dependent chain (slot -> em_face ->
    # faces -> vertices).  Radiance is NOT packed — it must stay a gather
    # from `radiance` so emitter gradients flow.  Layout (EF, 16) f32:
    # v0[0:3] e1[3:6] e2[6:9] area[9] prob[10] cdf_lo[11] cdf_hi[12]
    # emitter_id[13] (i32 bitcast) pad[14:16]
    em_face_packed: jnp.ndarray   # (EF, 16) f32
    face_dist: DiscreteDistribution  # over EF slots (weight = area * power)
    face_to_slot: jnp.ndarray     # (F,) i32 global face -> EF slot or -1
    # environment emitter (mi `constant` / `envmap`): scale * bilinear
    # equirect map, evaluated on ray misses (path-mis.py:41) and importance
    # sampled for NEE.  env_map is (1,1,3) ones for the constant case and
    # all-zeros scale when absent.
    env_radiance: jnp.ndarray     # (3,) scale
    env_map: jnp.ndarray          # (He, We, 3) equirect radiance
    env_dist: DiscreteDistribution2D  # over texels (luminance * sin(theta))
    env_select_p: jnp.ndarray     # () probability of NEE picking the env


@jstruct
class Camera:
    """Perspective pinhole camera, Mitsuba convention: local +Z = view
    direction, +Y = up, +X = left (see core.math.look_at)."""

    to_world: jnp.ndarray   # (4, 4) f32
    tan_half_fov: jnp.ndarray  # (2,) f32: (tan(fov_x/2), tan(fov_y/2))
    resolution: tuple = static_field(default=(256, 256))  # (W, H)

    @property
    def width(self):
        return self.resolution[0]

    @property
    def height(self):
        return self.resolution[1]


@jstruct
class BVH:
    """8-wide packed-row BVH (scene/bvh.py + scene/bvh8.py).

    One row gather fetches everything a traversal step needs:
      nodes    (NN8, 64) f32 — [0:8] child codes (bitcast i32: >=0 internal
               row, -1 empty, <=-2 leaf row -code-2); [8:56] 8x(lo|hi).
      leaf_tris (L, LEAF_ROW) f32 — LEAF_CAP packed triangles (9 floats
               each; layout derives from bvh8.LEAF_CAP, default 8 giving
               the historical 88-float row:) [0:72] vertices,
               [80:88] global face ids (bitcast i32, -1 pad; pad slots
               hold degenerate triangles that can never hit).
      leaf_face (L, 8)  i32 — the same face ids as a plain i32 table.
      unified  (NN8+L, 88) f32 — nodes zero-padded to 88 then leaves:
               ONE row gather per traversal iteration serves internal and
               leaf lanes (row i < NN8 internal, NN8 + j leaf j), so an
               iteration costs one gather whatever the lane's node kind.
    """

    nodes: jnp.ndarray      # (NN8, 64) f32
    leaf_tris: jnp.ndarray  # (L, 88) f32
    leaf_face: jnp.ndarray  # (L, 8) i32
    unified: jnp.ndarray    # (NN8+L, 88) f32
    # build-time layout (bvh8.BVHLayout), stamped by build_bvh as static
    # pytree aux data: jitted traversal reads row offsets / stack depth from
    # here, so non-default layouts are in-process testable (round-4 config
    # consolidation).  None only on hand-built BVHs -> consumers fall back
    # to bvh8.DEFAULT_LAYOUT.
    layout: object = static_field(default=None)


@jstruct
class Scene:
    geometry: Geometry
    materials: MaterialTable
    emitters: EmitterTable
    camera: Camera
    textures: TextureAtlas
    bvh: BVH

    @property
    def n_faces(self):
        return self.geometry.faces.shape[0]
