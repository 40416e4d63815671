"""Spectrum / polarization hooks — RGB-mode parity layer.

Every reference experiment uses the `*_ad_rgb` variants except patch.py
(`cuda_ad_spectral`), so this framework is RGB-first (SURVEY.md section 2.2
"Spectral/polarization hooks": keep Spectrum = Color3f, mueller ops as
identity).  These aliases keep call sites source-compatible with a future
spectral mode.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import math as m

is_spectral = False
is_monochromatic = False
is_polarized = False


def spectrum(value, n=None):
    """mi.Spectrum(x) analog: broadcast scalar/rgb to (..., 3)."""
    arr = jnp.asarray(value, m.Float)
    if arr.ndim == 0:
        arr = jnp.broadcast_to(arr, (3,))
    if n is not None and arr.ndim == 1:
        arr = jnp.broadcast_to(arr, (n, 3))
    return arr


def unpolarized_spectrum(s):
    """mi.unpolarized_spectrum: identity in RGB mode (path.py:71)."""
    return s


def to_world_mueller(value, wo, wi):
    """si.to_world_mueller: identity in unpolarized RGB mode
    (/root/reference/restirgi.py:546,554)."""
    return value


def spectrum_list_to_srgb(values, wavelengths=None, active=None):
    """mi.spectrum_list_to_srgb: RGB mode passthrough (path.py:85)."""
    return values


def luminance(rgb):
    return m.luminance(rgb)


# ---------------------------------------------------------------------------
# Hero-wavelength spectral mode (integrators/spectral.py).
#
# The reference's only spectral use is patch.py running a diffuse scene under
# the `cuda_ad_spectral` variant (Mitsuba supplies the machinery).  This is
# the JAX equivalent of that machinery: wavelength sampling, CIE 1931
# observer fits, RGB->spectrum upsampling, and XYZ->sRGB conversion.  All
# per-lane quantities are (N, K) arrays over K hero-rotated wavelengths —
# vector-friendly, no dynamic shapes.
# ---------------------------------------------------------------------------

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0


def sample_wavelengths(u, k: int = 4):
    """Hero-wavelength sampling (Wilkie et al. 2014): one uniform hero
    wavelength per lane plus k-1 equal-spaced rotations; pdf is uniform
    1/(LAMBDA_MAX-LAMBDA_MIN) for each.  u: (N,) -> (lambdas (N,k),
    pdf (N,k))."""
    span = LAMBDA_MAX - LAMBDA_MIN
    hero = LAMBDA_MIN + u * span
    rot = jnp.arange(k, dtype=m.Float) * (span / k)
    lam = LAMBDA_MIN + jnp.mod(hero[:, None] - LAMBDA_MIN + rot[None, :],
                               span)
    pdf = jnp.full_like(lam, 1.0 / span)
    return lam, pdf


def _gauss(x, alpha, mu, s1, s2):
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) * s
    return alpha * jnp.exp(-0.5 * t * t)


def cie_xyz_fit(lam):
    """CIE 1931 2-degree standard-observer fits (Wyman, Sloan, Shirley,
    JCGT 2013, multi-lobe Gaussians): lam (...,) nm -> (..., 3) xbar ybar
    zbar."""
    x = (
        _gauss(lam, 0.362, 442.0, 0.0624, 0.0374)
        + _gauss(lam, 1.056, 599.8, 0.0264, 0.0323)
        + _gauss(lam, -0.065, 501.1, 0.0490, 0.0382)
    )
    y = (
        _gauss(lam, 0.821, 568.8, 0.0213, 0.0247)
        + _gauss(lam, 0.286, 530.9, 0.0613, 0.0322)
    )
    z = (
        _gauss(lam, 1.217, 437.0, 0.0845, 0.0278)
        + _gauss(lam, 0.681, 459.0, 0.0385, 0.0725)
    )
    return jnp.stack([x, y, z], axis=-1)


# integral of ybar over the visible range (dense trapezoid at import, f64
# numpy -> f32 constant): normalizes radiometric W/(sr m^2 nm) to luminance
def _cmf_norm():
    # evaluate the same fits in numpy (host, import time — no device work)
    import numpy as np

    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 4701)

    def g(x, alpha, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        t = (x - mu) * s
        return alpha * np.exp(-0.5 * t * t)

    y = (g(lam, 0.821, 568.8, 0.0213, 0.0247)
         + g(lam, 0.286, 530.9, 0.0613, 0.0322))
    return float(np.trapezoid(y, lam))


CMF_Y_INTEGRAL = _cmf_norm()   # ~106.9 nm

# linear sRGB (D65) <- XYZ, IEC 61966-2-1 (host constant: module-level
# device arrays would force backend init at import)
import numpy as _np  # noqa: E402

XYZ_TO_SRGB = _np.asarray(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]], _np.float32,
)


def upsample_rgb(rgb, lam):
    """RGB reflectance -> smooth spectrum at lam: partition-of-unity sigmoid
    bands (transitions at 490/580 nm), so gray (r=g=b=a) upsamples to the
    EXACT constant spectrum a — furnace tests stay exact — and primaries map
    to smooth long/medium/short bands.  rgb (N,3) or (3,), lam (N,K) ->
    (N,K)."""
    rgb = jnp.asarray(rgb, m.Float)
    if rgb.ndim == 1:
        rgb = rgb[None, :]
    sig_b = jax.nn.sigmoid((490.0 - lam) * 0.08)        # short band
    sig_r = jax.nn.sigmoid((lam - 580.0) * 0.08)        # long band
    w_g = 1.0 - sig_b - sig_r                           # partition of unity
    return (
        rgb[:, 0:1] * sig_r + rgb[:, 1:2] * w_g + rgb[:, 2:3] * sig_b
    )


def spectrum_to_xyz_weight(lam, pdf, k: int):
    """Monte-Carlo film weight: radiance at lam splats CMF(lam)/(pdf*k) into
    XYZ (the 1/k averages the hero rotations), normalized so an equal-energy
    unit spectrum has Y = 1."""
    cmf = cie_xyz_fit(lam)                              # (N, K, 3)
    return cmf / (pdf[..., None] * k * CMF_Y_INTEGRAL)


def _equal_energy_white_srgb():
    """linear-sRGB coordinates of the equal-energy illuminant E under the
    fits above, Y-normalized (host numpy, import time)."""
    import numpy as np

    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 4701)

    def g(x, alpha, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        t = (x - mu) * s
        return alpha * np.exp(-0.5 * t * t)

    X = (g(lam, 0.362, 442.0, 0.0624, 0.0374)
         + g(lam, 1.056, 599.8, 0.0264, 0.0323)
         + g(lam, -0.065, 501.1, 0.0490, 0.0382))
    Y = (g(lam, 0.821, 568.8, 0.0213, 0.0247)
         + g(lam, 0.286, 530.9, 0.0613, 0.0322))
    Z = (g(lam, 1.217, 437.0, 0.0845, 0.0278)
         + g(lam, 0.681, 459.0, 0.0385, 0.0725))
    wxyz = np.array([np.trapezoid(X, lam), np.trapezoid(Y, lam),
                     np.trapezoid(Z, lam)]) / np.trapezoid(Y, lam)
    return XYZ_TO_SRGB @ wxyz


EQUAL_ENERGY_WHITE_SRGB = _np.asarray(_equal_energy_white_srgb(),
                                      _np.float32)


def xyz_to_srgb(xyz, white_balance: bool = True):
    """XYZ -> linear sRGB; with equal-energy white balance (the integrator's
    unit-test illuminant is E, not D65) so a flat spectrum maps to gray."""
    rgb = jnp.matmul(xyz, XYZ_TO_SRGB.T,
                     precision=jax.lax.Precision.HIGHEST)
    if white_balance:
        rgb = rgb / EQUAL_ENERGY_WHITE_SRGB
    return rgb

