"""BSDF library with masked multiplexing over material kinds.

Replaces Mitsuba's C++ BSDF plugins + Dr.Jit vcall dispatch
(bsdf.eval_pdf_sample at /root/reference/path.py:254, plugin zoo listed in
SURVEY.md section 2.2).  Polymorphism the XLA way: every lane evaluates every
lobe family once (pure elementwise arithmetic, no gathers besides the material-table
rows) and the per-lane result is selected by the `kind` column.  With ~7 lobe
families this costs less than the divergence/sort machinery it avoids; a
sort-by-material segmented path is the later optimization (SURVEY hard part #4).

Conventions (Mitsuba-compatible):
  * All directions in the local shading frame, +z = normal.
  * `eval` returns f(wi->wo) * |cos theta_o|; zero for delta lobes.
  * `pdf` is the solid-angle density of `sample`; zero for delta lobes.
  * `sample` returns (BSDFSample, weight = f * cos / pdf)  — for delta lobes
    the weight carries the full throughput and pdf is the discrete prob.
  * One-sided materials respond only for wi.z > 0; `twosided` rows flip the
    frame for back-side hits (the twosided adapter of the reference scenes).
"""
from __future__ import annotations

import jax.numpy as jnp

from ...core import math as m
from ...core import warp
from ...core.records import BSDFFlags, BSDFSample
from ...scene.types import BSDFKind, MaterialTable
from .. import fresnel as fr
from .. import microfacet as mf
from ..texture import eval_texture

_MIN_ALPHA = 1e-3


def _gather_rows(mats: MaterialTable, mat_id):
    """Gather per-lane material columns, resolving one MASK nesting level."""
    mid = jnp.maximum(mat_id, 0)
    kind = jnp.take(mats.kind, mid)
    nested = jnp.take(mats.nested_id, mid)
    is_mask = kind == BSDFKind.MASK
    eff = jnp.where(is_mask, jnp.maximum(nested, 0), mid)

    row = dict(
        kind=jnp.take(mats.kind, eff),
        base_color=jnp.take(mats.base_color, eff, axis=0),
        params=jnp.take(mats.params, eff, axis=0),
        tex_id=jnp.take(mats.tex_id, eff),
        twosided=jnp.take(mats.twosided, mid) | jnp.take(mats.twosided, eff),
        flags=jnp.take(mats.flags, mid),
        is_mask=is_mask,
        opacity=jnp.where(
            is_mask[:, None], jnp.take(mats.base_color, mid, axis=0), 1.0
        ),
        opacity_tex=jnp.where(is_mask, jnp.take(mats.tex_id, mid), -1),
    )
    return row


def bsdf_flags(mats: MaterialTable, mat_id):
    return jnp.take(mats.flags, jnp.maximum(mat_id, 0))


def base_color(mats: MaterialTable, textures, si):
    """Per-lane base color / reflectance lookup (texture-resolved) — the
    analog of fetching a property off a BSDF pointer via dr.dispatch
    (/root/reference/specular_from_bsdf.py:25-50)."""
    row = _gather_rows(mats, si.mat_id)
    return _albedo(row, textures, si.uv)


def _albedo(row, textures, uv):
    base = row["base_color"]
    tex = eval_texture(textures, row["tex_id"], uv)
    return jnp.where((row["tex_id"] >= 0)[:, None], base * tex, base)


def _opacity(row, textures, uv):
    op = row["opacity"]
    tex = eval_texture(textures, row["opacity_tex"], uv)
    return jnp.clip(
        jnp.where((row["opacity_tex"] >= 0)[:, None], tex, op), 0.0, 1.0
    )


def _flip_frame(row, wi, wo=None):
    """twosided adapter: flip z for back-side interactions of twosided
    non-transmissive materials (dielectrics handle sides natively)."""
    transmissive = (row["kind"] == BSDFKind.DIELECTRIC) | (
        row["kind"] == BSDFKind.ROUGH_DIELECTRIC
    ) | (row["kind"] == BSDFKind.NULL)
    flip = row["twosided"] & (wi[..., 2] < 0.0) & ~transmissive
    s = jnp.where(flip, -1.0, 1.0)
    wi_f = wi.at[..., 2].multiply(s)
    if wo is None:
        return wi_f, s
    return wi_f, wo.at[..., 2].multiply(s), s


# ===========================================================================
# Per-kind eval/pdf (smooth lobes; deltas return 0)
# ===========================================================================

_ALL_KINDS = frozenset(range(BSDFKind.COUNT))


def _as_present(present):
    """Static kinds filter: () / None = unknown = assume all kinds."""
    return _ALL_KINDS if not present else frozenset(present)


def _eval_pdf_kinds(row, albedo, wi, wo, present=None):
    """Returns per-kind (f (N,3), pdf (N,)) stacked for selection.

    Lobe families whose kind is statically absent from `present` are skipped
    entirely — the traced program only contains math for materials that
    actually occur in the scene."""
    present = _as_present(present)
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    n = wi.shape[0]
    zero3 = jnp.zeros((n, 3), m.Float)
    zero = jnp.zeros((n,), m.Float)
    f_tab: dict = {}
    pdf_tab: dict = {}

    reflect_side = (cos_i > 0.0) & (cos_o > 0.0)

    need_ggx = present & {
        BSDFKind.ROUGH_CONDUCTOR, BSDFKind.ROUGH_PLASTIC, BSDFKind.PRINCIPLED
    }
    need_pl = present & {BSDFKind.PLASTIC, BSDFKind.ROUGH_PLASTIC}

    # ---- diffuse ----------------------------------------------------------
    if BSDFKind.DIFFUSE in present:
        f_diff = albedo * (m.INV_PI * jnp.maximum(cos_o, 0.0))[:, None]
        f_tab[BSDFKind.DIFFUSE] = jnp.where(
            reflect_side[:, None], f_diff, 0.0
        )
        pdf_tab[BSDFKind.DIFFUSE] = jnp.where(
            reflect_side, warp.square_to_cosine_hemisphere_pdf(wo), 0.0
        )

    alpha = jnp.maximum(row["params"][:, 6], _MIN_ALPHA)
    eta = jnp.maximum(row["params"][:, 0], 1e-3)
    if need_ggx:
        h = m.normalize(wi + wo)
        h = h * m.sign_not_zero(h[..., 2])[..., None]
        D = mf.ggx_d(h, alpha)
        G = mf.smith_g(wi, wo, h, alpha)
        pdf_ggx_wo = m.safe_div(
            mf.pdf_ggx(h, alpha), 4.0 * jnp.abs(m.dot(wo, h))
        )

    # ---- rough conductor --------------------------------------------------
    if BSDFKind.ROUGH_CONDUCTOR in present:
        F_c = fr.fresnel_conductor(
            m.dot(wi, h), row["params"][:, 0:3], row["params"][:, 3:6]
        )
        spec = m.safe_div(D * G, 4.0 * jnp.abs(cos_i))
        f_rc = albedo * F_c * spec[:, None]
        f_tab[BSDFKind.ROUGH_CONDUCTOR] = jnp.where(
            reflect_side[:, None], f_rc, 0.0
        )
        pdf_tab[BSDFKind.ROUGH_CONDUCTOR] = jnp.where(
            reflect_side, pdf_ggx_wo, 0.0
        )

    # ---- rough dielectric -------------------------------------------------
    if BSDFKind.ROUGH_DIELECTRIC in present:
        f_rd, pdf_rd = _rough_dielectric_eval_pdf(
            row, albedo, wi, wo, eta, alpha
        )
        f_tab[BSDFKind.ROUGH_DIELECTRIC] = f_rd
        pdf_tab[BSDFKind.ROUGH_DIELECTRIC] = pdf_rd

    # ---- plastic (smooth): diffuse part only is smooth --------------------
    # f_diff = rho/pi * (1-F(wi))(1-F(wo)) / eta^2 / (1 - fdr_int), the
    # internal-scattering model of mitsuba's plastic (nonlinear=false)
    if need_pl:
        F_i = fr.fresnel_dielectric(cos_i, eta)[0]
        F_o = fr.fresnel_dielectric(cos_o, eta)[0]
        fdr_int = fr.fresnel_diffuse_reflectance(1.0 / eta)
        inv_eta2 = 1.0 / (eta * eta)
        diff_pl = albedo * m.safe_div(
            (1.0 - F_i) * (1.0 - F_o) * m.INV_PI * inv_eta2
            * jnp.maximum(cos_o, 0.0),
            (1.0 - fdr_int),
        )[:, None]
    if BSDFKind.PLASTIC in present:
        f_tab[BSDFKind.PLASTIC] = jnp.where(
            reflect_side[:, None], diff_pl, 0.0
        )
        pdf_tab[BSDFKind.PLASTIC] = jnp.where(
            reflect_side,
            (1.0 - F_i) * warp.square_to_cosine_hemisphere_pdf(wo),
            0.0,
        )

    # ---- rough plastic: GGX specular + diffuse ---------------------------
    if BSDFKind.ROUGH_PLASTIC in present:
        F_h = fr.fresnel_dielectric(m.dot(wi, h), eta)[0]
        spec_rp = m.safe_div(D * G * F_h, 4.0 * jnp.abs(cos_i))
        f_tab[BSDFKind.ROUGH_PLASTIC] = jnp.where(
            reflect_side[:, None], spec_rp[:, None] + diff_pl, 0.0
        )
        prob_spec_rp = jnp.clip(F_i, 0.25, 0.75)
        pdf_tab[BSDFKind.ROUGH_PLASTIC] = jnp.where(
            reflect_side,
            prob_spec_rp * pdf_ggx_wo
            + (1.0 - prob_spec_rp) * warp.square_to_cosine_hemisphere_pdf(wo),
            0.0,
        )

    # ---- principled (Disney-style metallic/roughness subset) --------------
    if BSDFKind.PRINCIPLED in present:
        metallic = row["params"][:, 0]
        spec_amt = row["params"][:, 1]
        f0 = (
            (0.08 * spec_amt * (1.0 - metallic))[:, None]
            + albedo * metallic[:, None]
        )
        F_schlick = f0 + (1.0 - f0) * jnp.clip(
            1.0 - jnp.abs(m.dot(wi, h)), 0.0, 1.0
        )[:, None] ** 5
        spec_pr = m.safe_div(D * G, 4.0 * jnp.abs(cos_i))
        diff_pr = (
            albedo
            * ((1.0 - metallic) * m.INV_PI * jnp.maximum(cos_o, 0.0))[:, None]
        )
        f_tab[BSDFKind.PRINCIPLED] = jnp.where(
            reflect_side[:, None], diff_pr + F_schlick * spec_pr[:, None], 0.0
        )
        p_spec_prn = jnp.clip(0.25 + 0.5 * metallic, 0.25, 0.9)
        pdf_tab[BSDFKind.PRINCIPLED] = jnp.where(
            reflect_side,
            p_spec_prn * pdf_ggx_wo
            + (1.0 - p_spec_prn) * warp.square_to_cosine_hemisphere_pdf(wo),
            0.0,
        )

    kind = row["kind"]
    f = _select_kind(kind, f_tab, zero3)
    pdf = _select_kind(kind, pdf_tab, zero)
    return f, pdf


def _select_kind(kind, table: dict, default):
    out = default
    for k, v in table.items():
        mask = kind == k
        out = jnp.where(
            mask.reshape(mask.shape + (1,) * (v.ndim - mask.ndim)), v, out
        )
    return out


def _rough_dielectric_eval_pdf(row, albedo, wi, wo, eta, alpha):
    """Walter-style rough dielectric (reflection + refraction lobes)."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    is_reflect = cos_i * cos_o > 0.0
    eta_it = jnp.where(cos_i >= 0.0, eta, 1.0 / eta)

    # half vector: reflection vs refraction form
    h_refl = m.normalize(wi + wo)
    h_refr = m.normalize(wi + wo * eta_it[..., None])
    h = jnp.where(is_reflect[..., None], h_refl, h_refr)
    h = h * m.sign_not_zero(h[..., 2])[..., None]

    D = mf.ggx_d(h, alpha)
    G = mf.smith_g(wi, wo, h, alpha)
    F = fr.fresnel_dielectric(m.dot(wi, h), eta)[0]

    # reflection
    f_r = m.safe_div(D * G * F, 4.0 * jnp.abs(cos_i))
    dwh_dwo_r = m.safe_div(jnp.ones_like(D), 4.0 * jnp.abs(m.dot(wo, h)))

    # refraction (Walter eq. 21)
    ih = m.dot(wi, h)
    oh = m.dot(wo, h)
    denom = ih + eta_it * oh
    jac = m.safe_div(eta_it * eta_it * jnp.abs(oh), denom * denom)
    f_t = m.safe_div(
        jnp.abs(ih * oh) * (1.0 - F) * D * G,
        jnp.abs(cos_i) * denom * denom,
    ) * eta_it * eta_it
    # radiance scale factor 1/eta^2 for transmission (solid-angle compression)
    f_t = f_t / (eta_it * eta_it)

    f_val = jnp.where(is_reflect, f_r, f_t)
    pdf = mf.pdf_ggx(h, alpha) * jnp.where(
        is_reflect, F * dwh_dwo_r, (1.0 - F) * jac
    )
    valid = D > 0.0
    f3 = albedo * jnp.where(valid, f_val, 0.0)[:, None]
    return f3, jnp.where(valid, pdf, 0.0)


# ===========================================================================
# Public API
# ===========================================================================

def eval_pdf(mats, textures, si, wo, active=None):
    """(f, pdf) for direction wo given si (both local frame)."""
    present = _as_present(mats.kinds_present)
    row = _gather_rows(mats, si.mat_id)
    wi_f, wo_f, _ = _flip_frame(row, si.wi, wo)
    albedo = _albedo(row, textures, si.uv)
    f, pdf = _eval_pdf_kinds(row, albedo, wi_f, wo_f, present)
    if BSDFKind.MASK in present:
        # mask wrapper: scale by opacity
        op = _opacity(row, textures, si.uv)
        op_l = m.luminance(op)
        f = jnp.where(row["is_mask"][:, None], f * op, f)
        pdf = jnp.where(row["is_mask"], pdf * op_l, pdf)
    valid = si.mat_id >= 0
    if active is not None:
        valid = valid & active
    return jnp.where(valid[:, None], f, 0.0), jnp.where(valid, pdf, 0.0)


def sample(mats, textures, si, u1, u2, active=None):
    """Sample wo ~ BSDF; returns (BSDFSample, weight).

    Candidate generation for statically absent kinds is skipped (see
    _eval_pdf_kinds)."""
    K = BSDFKind
    present = _as_present(mats.kinds_present)
    row = _gather_rows(mats, si.mat_id)
    wi, flip_sign = _flip_frame(row, si.wi)
    albedo = _albedo(row, textures, si.uv)
    n = wi.shape[0]
    cos_i = wi[..., 2]
    kind = row["kind"]
    eta_rel = jnp.maximum(row["params"][:, 0], 1e-3)
    alpha = jnp.maximum(row["params"][:, 6], _MIN_ALPHA)
    ones = jnp.ones((n,), m.Float)
    false = jnp.zeros((n,), bool)
    wo_tab: dict = {}
    w_tab: dict = {}
    pdf_tab: dict = {}
    eta_tab: dict = {}
    refl_d = refl_rd = spec_pl = mask_pass = false
    op = jnp.ones((n, 3), m.Float)
    op_l = ones

    # --- mask pass-through lobe -------------------------------------------
    if K.MASK in present:
        op = _opacity(row, textures, si.uv)
        op_l = jnp.clip(m.luminance(op), 1e-4, 1.0 - 1e-4)
        mask_pass = row["is_mask"] & (u1 >= op_l)
        # renormalize u1 within the kept branch
        u1 = jnp.where(
            row["is_mask"], jnp.clip(m.safe_div(u1, op_l), 0.0, 1.0 - 1e-6),
            u1,
        )

    # --- per-kind candidate samples ---------------------------------------
    # diffuse: cosine hemisphere (always traced: fallback default direction)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_diff)
    w_diff = albedo  # f*cos/pdf = albedo
    wo_tab[K.DIFFUSE] = wo_diff
    w_tab[K.DIFFUSE] = w_diff
    pdf_tab[K.DIFFUSE] = pdf_diff

    # smooth conductor: mirror
    if K.CONDUCTOR in present:
        wo_tab[K.CONDUCTOR] = m.reflect(wi)
        F_c = fr.fresnel_conductor(
            cos_i, row["params"][:, 0:3], row["params"][:, 3:6]
        )
        w_tab[K.CONDUCTOR] = albedo * F_c
        pdf_tab[K.CONDUCTOR] = ones

    # GGX half-vector (shared by rough conductor/plastic/principled/dielectric)
    if present & {
        K.ROUGH_CONDUCTOR, K.ROUGH_PLASTIC, K.PRINCIPLED, K.ROUGH_DIELECTRIC
    }:
        h, pdf_h = mf.sample_ggx(u2, alpha)
        wo_rc = m.reflect_about(wi, h)

    if K.ROUGH_CONDUCTOR in present:
        wo_tab[K.ROUGH_CONDUCTOR] = wo_rc
        pdf_tab[K.ROUGH_CONDUCTOR] = m.safe_div(
            pdf_h, 4.0 * jnp.abs(m.dot(wo_rc, h))
        )
        G_rc = mf.smith_g(wi, wo_rc, h, alpha)
        F_rc = fr.fresnel_conductor(
            m.dot(wi, h), row["params"][:, 0:3], row["params"][:, 3:6]
        )
        # weight = F * G * <wi,h> / (<wi,n> <h,n>)   (D cancels)
        w_rc = albedo * F_rc * m.safe_div(
            G_rc * m.dot(wi, h), cos_i * h[..., 2]
        )[:, None]
        w_tab[K.ROUGH_CONDUCTOR] = jnp.where(
            (wo_rc[..., 2] * cos_i > 0.0)[:, None], w_rc, 0.0
        )

    # smooth dielectric: reflect/refract by Fresnel
    if K.DIELECTRIC in present:
        F_d, cos_t, eta_it, eta_ti = fr.fresnel_dielectric(cos_i, eta_rel)
        refl_d = u1 < F_d
        wo_tab[K.DIELECTRIC] = jnp.where(
            refl_d[:, None], m.reflect(wi), m.refract(wi, cos_t, eta_ti)
        )
        w_tab[K.DIELECTRIC] = albedo * jnp.where(
            refl_d, 1.0, eta_ti * eta_ti  # radiance scaling on refraction
        )[:, None]
        pdf_tab[K.DIELECTRIC] = jnp.where(refl_d, F_d, 1.0 - F_d)
        eta_tab[K.DIELECTRIC] = jnp.where(refl_d, 1.0, eta_it)

    # rough dielectric: GGX half-vector + fresnel choice
    if K.ROUGH_DIELECTRIC in present:
        F_h, cos_t_h, eta_it_h, eta_ti_h = fr.fresnel_dielectric(
            m.dot(wi, h), eta_rel
        )
        refl_rd = u1 < F_h
        wo_rd_r = m.reflect_about(wi, h)
        # refract about h: build from Snell in the h frame
        ih = m.dot(wi, h)
        c_abs = jnp.abs(cos_t_h)
        wo_rd_t = m.normalize(
            (eta_ti_h * jnp.abs(ih) - c_abs)[:, None] * h
            * m.sign_not_zero(ih)[:, None]
            - eta_ti_h[:, None] * wi
        )
        wo_rd = jnp.where(refl_rd[:, None], wo_rd_r, wo_rd_t)
        # _rough_dielectric_eval_pdf returns f * |cos_o| (Mitsuba convention)
        f_rd3, pdf_rd = _rough_dielectric_eval_pdf(
            row, albedo, wi, wo_rd, eta_rel, alpha
        )
        wo_tab[K.ROUGH_DIELECTRIC] = wo_rd
        w_tab[K.ROUGH_DIELECTRIC] = m.safe_div(f_rd3, pdf_rd[:, None])
        pdf_tab[K.ROUGH_DIELECTRIC] = pdf_rd
        eta_tab[K.ROUGH_DIELECTRIC] = jnp.where(refl_rd, 1.0, eta_it_h)

    # plastic (smooth): fresnel-weighted specular or diffuse
    if present & {K.PLASTIC, K.ROUGH_PLASTIC}:
        F_i = fr.fresnel_dielectric(cos_i, eta_rel)[0]
    if K.PLASTIC in present:
        spec_pl = u1 < F_i
        wo_pl = jnp.where(spec_pl[:, None], m.reflect(wi), wo_diff)
        fdr_int = fr.fresnel_diffuse_reflectance(1.0 / eta_rel)
        inv_eta2 = 1.0 / (eta_rel * eta_rel)
        F_o_pl = fr.fresnel_dielectric(wo_pl[..., 2], eta_rel)[0]
        # diffuse weight = f*cos/pdf with pdf = (1-F_i) * cos/pi
        w_pl_diff = albedo * m.safe_div(
            (1.0 - F_o_pl) * inv_eta2, 1.0 - fdr_int
        )[:, None]
        wo_tab[K.PLASTIC] = wo_pl
        w_tab[K.PLASTIC] = jnp.where(
            spec_pl[:, None], jnp.ones_like(albedo), w_pl_diff
        )
        pdf_tab[K.PLASTIC] = jnp.where(spec_pl, F_i, (1.0 - F_i) * pdf_diff)

    # rough plastic: choose GGX spec vs diffuse
    if K.ROUGH_PLASTIC in present:
        prob_spec_rp = jnp.clip(F_i, 0.25, 0.75)
        spec_rp = u1 < prob_spec_rp
        wo_rp = jnp.where(spec_rp[:, None], wo_rc, wo_diff)
        f_rp, pdf_rp = _eval_pdf_kinds(
            {**row, "kind": jnp.full_like(kind, K.ROUGH_PLASTIC)},
            albedo, wi, wo_rp, {K.ROUGH_PLASTIC},
        )
        wo_tab[K.ROUGH_PLASTIC] = wo_rp
        w_tab[K.ROUGH_PLASTIC] = m.safe_div(f_rp, pdf_rp[:, None])
        pdf_tab[K.ROUGH_PLASTIC] = pdf_rp

    # principled: GGX spec vs cosine diffuse by metallic-weighted prob
    if K.PRINCIPLED in present:
        metallic = row["params"][:, 0]
        p_spec_prn = jnp.clip(0.25 + 0.5 * metallic, 0.25, 0.9)
        spec_prn = u1 < p_spec_prn
        wo_prn = jnp.where(spec_prn[:, None], wo_rc, wo_diff)
        f_prn_s, pdf_prn_s = _eval_pdf_kinds(
            {**row, "kind": jnp.full_like(kind, K.PRINCIPLED)},
            albedo, wi, wo_prn, {K.PRINCIPLED},
        )
        wo_tab[K.PRINCIPLED] = wo_prn
        w_tab[K.PRINCIPLED] = m.safe_div(f_prn_s, pdf_prn_s[:, None])
        pdf_tab[K.PRINCIPLED] = pdf_prn_s

    # null: straight through
    if K.NULL in present:
        wo_tab[K.NULL] = -wi
        w_tab[K.NULL] = jnp.ones((n, 3), m.Float)
        pdf_tab[K.NULL] = ones

    # --- select by kind ----------------------------------------------------
    wo = _select_kind(kind, wo_tab, wo_diff)
    weight = _select_kind(kind, w_tab, w_diff)
    pdf = _select_kind(kind, pdf_tab, pdf_diff)
    eta_out = _select_kind(kind, eta_tab, ones)
    delta_kinds = (
        (kind == BSDFKind.CONDUCTOR)
        | (kind == BSDFKind.DIELECTRIC)
        | ((kind == BSDFKind.PLASTIC) & spec_pl)
        | (kind == BSDFKind.NULL)
    )
    stype = jnp.where(
        delta_kinds,
        jnp.where(
            (kind == BSDFKind.DIELECTRIC) & ~refl_d,
            BSDFFlags.DeltaTransmission,
            jnp.where(
                kind == BSDFKind.NULL, BSDFFlags.Null, BSDFFlags.DeltaReflection
            ),
        ),
        jnp.where(
            kind == BSDFKind.DIFFUSE,
            BSDFFlags.DiffuseReflection,
            jnp.where(
                (kind == BSDFKind.ROUGH_DIELECTRIC) & ~refl_rd,
                BSDFFlags.GlossyTransmission,
                BSDFFlags.GlossyReflection,
            ),
        ),
    ).astype(jnp.int32)

    # --- mask wrapper: pass-through overrides ------------------------------
    if K.MASK in present:
        weight = jnp.where(
            row["is_mask"][:, None],
            jnp.where(
                mask_pass[:, None],
                m.safe_div(1.0 - op, (1.0 - op_l)[:, None]),
                weight * m.safe_div(op, op_l[:, None]),
            ),
            weight,
        )
        wo = jnp.where(mask_pass[:, None], -wi, wo)
        pdf = jnp.where(
            mask_pass, 1.0 - op_l,
            jnp.where(row["is_mask"], pdf * op_l, pdf),
        )
        stype = jnp.where(mask_pass, BSDFFlags.Null, stype)
        eta_out = jnp.where(mask_pass, 1.0, eta_out)

    # --- validity ----------------------------------------------------------
    valid = si.mat_id >= 0
    if active is not None:
        valid = valid & active
    # one-sided materials: no response from the back
    transmissive = (
        (kind == BSDFKind.DIELECTRIC)
        | (kind == BSDFKind.ROUGH_DIELECTRIC)
        | (kind == BSDFKind.NULL)
    )
    front_ok = (cos_i > 0.0) | transmissive | mask_pass
    # hemisphere check: a GGX-sampled half-vector can reflect wo below the
    # surface — such samples are invalid (pdf -> 0), matching Mitsuba
    same_side = wo[..., 2] * cos_i > 0.0
    hemi_ok = jnp.where(
        transmissive,
        jnp.where(
            kind == BSDFKind.ROUGH_DIELECTRIC,
            jnp.where(refl_rd, same_side, wo[..., 2] * cos_i < 0.0),
            True,
        ),
        same_side,
    )
    hemi_ok |= mask_pass
    valid &= front_ok & hemi_ok & (pdf > 0.0)

    weight = jnp.where(valid[:, None], weight, 0.0)
    weight = jnp.maximum(weight, 0.0)

    # un-flip wo back to the true frame
    wo = wo.at[..., 2].multiply(flip_sign)

    bs = BSDFSample(
        wo=wo,
        pdf=jnp.where(valid, pdf, 0.0),
        eta=eta_out,
        sampled_type=jnp.where(valid, stype, 0),
    )
    return bs, weight


def eval_pdf_sample(mats, textures, si, wo_query, u1, u2, active=None):
    """Fused eval_pdf + sample (bsdf.eval_pdf_sample, path.py:254)."""
    f, pdf = eval_pdf(mats, textures, si, wo_query, active)
    bs, weight = sample(mats, textures, si, u1, u2, active)
    return f, pdf, bs, weight
