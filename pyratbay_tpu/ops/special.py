"""Special functions: exponential integrals, Faddeeva / Voigt profiles,
and broadening half-widths.

All device functions are elementwise and fully vectorized;
no data-dependent control flow (branches become jnp.where selects).

Voigt conventions (reference pyratbay/opacity/broadening/broadening.py):
profiles are area-normalized, parameterized by Lorentz and Doppler
half-widths at half-maximum (HWHM).
"""
import functools

import numpy as np
import jax.numpy as jnp
from jax.scipy import special as jsp

from .. import constants as pc

__all__ = [
    'e2',
    'wofz_real',
    'voigt_profile',
    'voigt_ref',
    'Gauss',
    'Lorentz',
    'Voigt',
    'doppler_hwhm',
    'lorentz_hwhm',
    'min_widths',
    'max_widths',
]

_SQRT_PI = np.sqrt(np.pi)
_SQRT_LN2 = np.sqrt(np.log(2.0))


_EULER_GAMMA = 0.5772156649015329


def exp1(x):
    """Exponential integral E_1(x) for x > 0, fully vectorized.

    Power series for x <= 1, modified-Lentz continued fraction for
    x > 1; both with fixed iteration counts (no data-dependent control
    flow), accurate to ~1e-15 relative.  jax.scipy.special.exp1 uses a
    per-element while_loop that is pathologically slow on large arrays.
    """
    x = jnp.asarray(x)
    xs = jnp.where(x > 0, x, 1.0)

    # Series: E1 = -gamma - ln x + sum (-1)^{k+1} x^k / (k k!):
    xsmall = jnp.minimum(xs, 1.0)
    term = jnp.ones_like(xsmall)
    series = jnp.zeros_like(xsmall)
    for k in range(1, 26):
        term = term * (-xsmall) / k
        series = series - term / k
    small = -_EULER_GAMMA - jnp.log(xsmall) + series

    # Continued fraction (A&S 5.1.22), evaluated bottom-up with a
    # fixed depth: E1 = e^-x / (x + 1/(1 + 1/(x + 2/(1 + 2/(x + ...
    xl = jnp.maximum(xs, 1.0)
    cf = jnp.zeros_like(xl)
    for k in range(30, 0, -1):
        cf = k / (1.0 + k / (xl + cf))
    large = jnp.exp(-xl) / (xl + cf)

    return jnp.where(x <= 1.0, small, large)


def e2(x):
    """Exponential integral E_2(x) = exp(-x) - x*E_1(x), for x >= 0."""
    x = jnp.asarray(x)
    safe = jnp.where(x > 0, x, 1.0)
    val = jnp.exp(-safe) - safe * exp1(safe)
    return jnp.where(x > 0, val, 1.0)  # E_2(0) = 1


@functools.lru_cache(maxsize=None)
def _weideman_coeffs(n_terms):
    """Polynomial coefficients for Weideman's (1994) rational approximation
    of the Faddeeva function w(z) in the upper half-plane.
    """
    m = 2 * n_terms
    m2 = 2 * m
    kk = np.arange(-m + 1, m)
    length = np.sqrt(n_terms / np.sqrt(2.0))
    theta = kk * np.pi / m
    t = length * np.tan(theta / 2.0)
    f = np.exp(-t**2) * (length**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    a = np.flipud(a[1:n_terms + 1])
    return length, a


def _wofz_real_asymptotic(x, y):
    """Large-|z| asymptotic series Re[w] = Re[i/(sqrt(pi) z) (1 + 1/2z^2
    + 3/4z^4 + ...)]; relative error < 3e-10 for |z| >= 14."""
    # Clamp so the untaken branch of the caller's select stays finite
    # (jnp.where evaluates both sides; NaNs would poison gradients):
    r2 = jnp.maximum(x**2 + y**2, 1.0)
    # q = 1/z^2 (complex), computed in real arithmetic:
    re_q = (x**2 - y**2) / r2**2
    im_q = -2.0 * x * y / r2**2
    # Horner for S = 1 + q(1/2 + q(3/4 + q(15/8 + q(105/16 + q*945/32)))):
    re_s, im_s = 29.53125, 0.0
    for coeff in (6.5625, 1.875, 0.75, 0.5):
        re_s, im_s = (
            re_s * re_q - im_s * im_q + coeff,
            re_s * im_q + im_s * re_q,
        )
    re_s, im_s = re_s * re_q - im_s * im_q + 1.0, re_s * im_q + im_s * re_q
    # i/z = (y + i x)/r2;  Re[(i/z) S / sqrt(pi)]:
    return (y * re_s - x * im_s) / (r2 * _SQRT_PI)


def _weideman(x, y, n_terms=32):
    """Weideman (1994) rational approximation of w(x + iy), y >= 0.

    Returns (Re w, Im w).  Real arithmetic only (Pallas-portable).
    """
    length, a = _weideman_coeffs(n_terms)
    # Z = (L + i z)/(L - i z) with z = x + i y:
    # L + iz = (L - y) + i x ;  L - iz = (L + y) - i x
    re_num, im_num = length - y, x
    re_den, im_den = length + y, -x
    den2 = re_den**2 + im_den**2
    re_z = (re_num * re_den + im_num * im_den) / den2
    im_z = (im_num * re_den - re_num * im_den) / den2
    # Horner evaluation of p(Z) with real coefficients:
    re_p = jnp.zeros_like(re_z) + a[0]
    im_p = jnp.zeros_like(re_z)
    for coeff in a[1:]:
        re_p, im_p = (
            re_p * re_z - im_p * im_z + coeff,
            re_p * im_z + im_p * re_z,
        )
    # w = 2 p / (L - i z)^2 + (1/sqrt(pi)) / (L - i z)
    re_d2 = re_den**2 - im_den**2
    im_d2 = 2.0 * re_den * im_den
    d4 = re_d2**2 + im_d2**2
    re_q = (re_p * re_d2 + im_p * im_d2) / d4
    im_q = (im_p * re_d2 - re_p * im_d2) / d4
    re_w = 2.0 * re_q + re_den / den2 / _SQRT_PI
    im_w = 2.0 * im_q - im_den / den2 / _SQRT_PI
    return re_w, im_w


def _wofz_real_small_y(x, y, n_terms=32):
    """Exact-Gaussian decomposition for small y (< ~0.03).

    K(x,y) = Re[e^{-z^2}] - (2/sqrt(pi)) Im[F_c(z)] with F_c the entire
    complex Dawson function; Im F_c is Taylor-expanded in y around the
    real axis using the Dawson recurrence F' = 1 - 2xF.  This isolates
    the e^{-x^2} cancellation that destroys the rational approximation's
    relative accuracy near the real axis.
    """
    _, im_w0 = _weideman(x, jnp.zeros_like(x), n_terms)
    daw = 0.5 * _SQRT_PI * im_w0      # Dawson F(x)
    f1 = 1.0 - 2.0 * x * daw
    f2 = -2.0 * daw - 2.0 * x * f1
    f3 = -4.0 * f1 - 2.0 * x * f2
    f4 = -6.0 * f2 - 2.0 * x * f3
    f5 = -8.0 * f3 - 2.0 * x * f4
    gauss = jnp.exp(y * y - x * x) * jnp.cos(2.0 * x * y)
    im_fc = y * f1 - y**3 / 6.0 * f3 + y**5 / 120.0 * f5
    return gauss - 2.0 / _SQRT_PI * im_fc


def wofz_real(x, y, n_terms=None):
    """Real part of the Faddeeva function w(x + i y), y >= 0.

    Three fixed-cost regions selected by masks (no data-dependent
    control flow):
      * y < 0.03: exact-Gaussian + Dawson-Taylor decomposition;
      * interior: Weideman (1994) rational approximation;
      * x^2 + y^2 >= 196: large-|z| asymptotic series.
    Uniform relative error < ~3e-10 over the Voigt domain at 32 terms
    (float64 default); float32 inputs default to 16 terms (~1e-6,
    below float32 resolution) for half the op count.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    x, y = jnp.broadcast_arrays(x, y)
    if n_terms is None:
        n_terms = 16 if x.dtype == jnp.float32 else 32
    re_w, _ = _weideman(x, y, n_terms)
    out = jnp.where(y < 0.03, _wofz_real_small_y(x, y, n_terms), re_w)
    return jnp.where(
        x**2 + y**2 >= 196.0,
        _wofz_real_asymptotic(x, y),
        out,
    )


def voigt_profile(x, hwhm_lor, hwhm_dop, n_terms=32):
    """Area-normalized Voigt profile V(x; hwhm_L, hwhm_G).

    V = Re[w((x + i hwhm_L) sqrt(ln2)/hwhm_G)] * sqrt(ln2/pi) / hwhm_G
    """
    sigma = hwhm_dop / _SQRT_LN2
    xx = x / sigma
    yy = hwhm_lor / sigma
    return wofz_real(xx, yy, n_terms) / (sigma * _SQRT_PI)


# 4-term rational approximation (Martin & Puerta-Bobadilla style) used by
# the reference when HWHM_L/HWHM_G >= 0.1 (broadening.py:250-263):
_VA = np.array([-1.2150, -1.3509, -1.2150, -1.3509])
_VB = np.array([1.2359, 0.3786, -1.2359, -0.3786])
_VC = np.array([-0.3085, 0.5906, -0.3085, 0.5906])
_VD = np.array([0.0210, -1.1858, -0.0210, 1.1858])
_SQRT_PI_LN2 = np.sqrt(np.pi * np.log(2.0))


def voigt_ref(x, hwhm_lor, hwhm_dop):
    """Reference-compatible Voigt profile.

    Mirrors pyratbay/opacity/broadening/broadening.py:231-263 exactly:
    exact Faddeeva evaluation when HWHM_L/HWHM_G < 0.1, else the 4-term
    rational approximation.  Use this where bit-level parity with the
    reference golden spectra matters (e.g. alkali detuning anchors);
    use `voigt_profile` (uniformly accurate) everywhere else.
    """
    x = jnp.asarray(x)
    hwhm_lor = jnp.asarray(hwhm_lor)
    hwhm_dop = jnp.asarray(hwhm_dop)

    # Branch 1: exact.
    exact = voigt_profile(x, hwhm_lor, hwhm_dop)

    # Branch 2: 4-term rational.
    xx = x * _SQRT_LN2 / hwhm_dop
    yy = hwhm_lor * _SQRT_LN2 / hwhm_dop
    v = jnp.zeros_like(xx)
    for ai, bi, ci, di in zip(_VA, _VB, _VC, _VD):
        v = v + (ci * (yy - ai) + di * (xx - bi)) / (
            (yy - ai)**2 + (xx - bi)**2
        )
    rational = v * _SQRT_PI_LN2 / (np.pi * hwhm_dop)

    return jnp.where(hwhm_lor / hwhm_dop < 0.1, exact, rational)


class Lorentz:
    """Area-normalized 1D Lorentz profile (reference
    opacity/broadening/broadening.py:20-76): callable object with
    center x0, half-width hwhm, and scale."""

    def __init__(self, x0=0.0, hwhm=1.0, scale=1.0):
        self.x0 = x0
        self.hwhm = hwhm
        self.scale = scale

    def __call__(self, x):
        x = jnp.asarray(x)
        return (
            self.scale * self.hwhm / np.pi
            / (self.hwhm**2 + (x - self.x0)**2)
        )


class Gauss:
    """Area-normalized 1D Gaussian profile parameterized by its HWHM
    (reference broadening.py:79-141)."""

    def __init__(self, x0=0.0, hwhm=1.0, scale=1.0):
        self.x0 = x0
        self.hwhm = hwhm
        self.scale = scale

    def __call__(self, x):
        x = jnp.asarray(x)
        sigma = self.hwhm / np.sqrt(2.0 * np.log(2.0))
        return (
            self.scale / (sigma * np.sqrt(2.0 * np.pi))
            * jnp.exp(-0.5 * ((x - self.x0) / sigma)**2)
        )


class Voigt:
    """Area-normalized 1D Voigt profile object (reference
    broadening.py:144-262): callable with x0, hwhm_L, hwhm_G, scale;
    evaluates the reference-compatible branch selection (exact
    Faddeeva for hwhm_L/hwhm_G < 0.1, 4-term rational otherwise)."""

    def __init__(self, x0=0.0, hwhm_L=1.0, hwhm_G=1.0, scale=1.0):
        self.x0 = x0
        self.hwhm_L = hwhm_L
        self.hwhm_G = hwhm_G
        self.scale = scale

    def __call__(self, x):
        return self.scale * voigt_ref(
            jnp.asarray(x) - self.x0, self.hwhm_L, self.hwhm_G,
        )


def doppler_hwhm(temperature, mass, wn):
    """Doppler HWHM (cm-1); mass in amu, wn in cm-1, T in K."""
    return (
        wn / pc.c
        * jnp.sqrt(2.0 * np.log(2.0) * pc.k * temperature / (mass * pc.amu))
    )


def lorentz_hwhm(temperature, pressure, masses, radii, vmr, imol):
    """Pressure-broadening Lorentz HWHM (cm-1).

    pressure in bar; masses in amu; radii in cm; vmr per species.
    imol indexes the absorbing species in masses/radii.
    """
    masses = jnp.asarray(masses)
    radii = jnp.asarray(radii)
    vmr = jnp.asarray(vmr)
    imol = jnp.atleast_1d(jnp.asarray(imol))
    # Sum over colliders (axis -1) for each target species in imol:
    coll = jnp.sum(
        vmr[None, :] * (radii[None, :] + radii[imol, None])**2
        * jnp.sqrt(1.0 / masses[None, :] + 1.0 / masses[imol, None]),
        axis=-1,
    )
    return (
        pressure * pc.bar / pc.c
        * jnp.sqrt(2.0 / (np.pi * pc.k * temperature * pc.amu))
        * coll
    )


_H2_RADIUS = 1.445e-8  # cm
_H2_MASS = 2.01588     # amu


def min_widths(min_temp, max_temp, min_wn, max_mass, min_rad, min_press):
    """Minimum Doppler/Lorentz HWHM bounds for an H2-dominated atmosphere."""
    dmin = (
        np.sqrt(2.0 * np.log(2.0) * pc.k * min_temp / (max_mass * pc.amu))
        * min_wn / pc.c
    )
    min_diam = _H2_RADIUS + min_rad
    lmin = (
        np.sqrt(2.0 / (np.pi * pc.k * max_temp * pc.amu))
        * min_press * pc.bar * min_diam**2 / pc.c
        * np.sqrt(1.0 / max_mass + 1.0 / _H2_MASS)
    )
    return dmin, lmin


def max_widths(min_temp, max_temp, max_wn, min_mass, max_rad, max_press):
    """Maximum Doppler/Lorentz HWHM bounds for an H2-dominated atmosphere."""
    dmax = (
        np.sqrt(2.0 * np.log(2.0) * pc.k * max_temp / (min_mass * pc.amu))
        * max_wn / pc.c
    )
    max_diam = _H2_RADIUS + max_rad
    lmax = (
        np.sqrt(2.0 / (np.pi * pc.k * min_temp * pc.amu))
        * max_press * pc.bar * max_diam**2 / pc.c
        * np.sqrt(1.0 / min_mass + 1.0 / _H2_MASS)
    )
    return dmax, lmax
