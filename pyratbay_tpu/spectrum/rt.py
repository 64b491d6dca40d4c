"""Radiative-transfer solvers: transit transmission, plane-parallel
emission, and two-stream fluxes.

Dense-array redesign of the reference's per-wavelength C loops
(src_c/_trapezoid.c, pyratbay/spectrum/radiative_transfer.py):

* The transit optical depth is a single [nlayers, nlayers-1] x
  [nlayers-1, nwave] matmul against the chord-geometry matrix instead
  of a scalar loop per impact parameter.
* Early-stop bookkeeping (`ideep`, the layer where tau > maxdepth) is
  replaced by masked full-depth integration: every wavelength integrates
  the same static shape and a comparison mask reproduces the reference's
  stop semantics exactly.
* The layer recurrences (two-stream) are lax.scans.

All functions are pure and jit/vmap/grad-safe, including traced deck
parameters (cloud-top index enters only through gathers and masks).
"""
import numpy as np
import scipy.special as ss
import jax.numpy as jnp
from jax import lax

from .. import constants as pc
from ..ops.planck import blackbody_wn

__all__ = [
    'transit_depth',
    'transmission_spectrum',
    'plane_parallel_depth',
    'plane_parallel_intensity',
    'two_stream',
    'gauss_quadrature',
]


def transit_depth(ec, path, maxdepth=np.inf, itop=0, ibottom=None):
    """Transmission optical depth for every impact parameter.

    Parameters
    ----------
    ec: [nlayers, nwave] extinction coefficient (cm-1).
    path: [nlayers, nlayers-1] chord matrix (transit_path_matrix).
    maxdepth: stop threshold; deeper layers are flagged via ideep.
    itop/ibottom: top layer index / one-past-bottom layer index.

    Returns
    -------
    depth: [nlayers, nwave]; rows outside [itop, ibottom) are zero.
    ideep: [nwave] int; per wavelength, the first layer where depth
        exceeds maxdepth (or ibottom-1 if none does).  Reference
        semantics: _trapezoid.c:238-276, opacity/optic_depth.py:104-121.
    """
    nlayers, nwave = ec.shape
    if ibottom is None:
        ibottom = nlayers
    # tau(r) = sum_i path[r,i] * (ec[i] + ec[i+1])  -- the "2x chord"
    # convention folds the usual 1/2 trapezoid factor.  The pair sum is
    # folded into the (tiny) chord matrix instead of materializing an
    # [nlayers-1, nwave] ec_mid buffer: the forward is HBM-bound, and
    # path2[r, j] = path[r, j-1] + path[r, j] gives the identical
    # contraction from ec directly.
    path2 = (
        jnp.pad(path, ((0, 0), (1, 0))) + jnp.pad(path, ((0, 0), (0, 1)))
    )
    depth = jnp.matmul(path2, ec, precision=lax.Precision.HIGHEST)

    rows = jnp.arange(nlayers)
    in_range = (rows >= itop) & (rows < ibottom)
    depth = jnp.where(in_range[:, None], depth, 0.0)

    exceeded = (depth > maxdepth) & in_range[:, None]
    any_exceed = jnp.any(exceeded, axis=0)
    first_exceed = jnp.argmax(exceeded, axis=0)
    ideep = jnp.where(any_exceed, first_exceed, ibottom - 1)
    return depth, ideep


def transmission_spectrum(
        depth, ideep, radius, rstar, itop=0,
        deck_rsurf=None, deck_itop=None,
    ):
    """Transit (Rp/Rs)^2 spectrum from per-impact-parameter optical depth.

    spectrum = (r[itop]^2 + 2 * integral e^-tau r dr) / rstar^2,
    integrating each wavelength down to its ideep layer.  An opaque cloud
    deck splices the integration boundary at (deck_itop, deck_rsurf)
    (reference spectrum/radiative_transfer.py:23-73).
    """
    nlayers, nwave = depth.shape
    radius = jnp.asarray(radius)
    integ = jnp.exp(-depth) * radius[:, None]          # [lay, wave]
    h = radius[1:] - radius[:-1]                       # negative (top-down)

    if deck_rsurf is not None:
        # Replace the last integration step with the cloud surface:
        # h[deck_itop-1] spans from radius[deck_itop-1] to rsurf, and
        # integ[deck_itop] is interpolated at rsurf.
        j = deck_itop - 1
        w = (radius[j] - deck_rsurf) / (radius[j] - radius[j + 1])
        integ_surf = integ[j] * (1.0 - w) + integ[j + 1] * w
        apply = deck_itop > itop
        h = jnp.where(
            jnp.arange(nlayers - 1) == j,
            jnp.where(apply, deck_rsurf - radius[j], h[jnp.clip(j, 0)]),
            h,
        )
        integ = jnp.where(
            (jnp.arange(nlayers) == deck_itop)[:, None] & apply,
            integ_surf[None, :],
            integ,
        )

    terms = 0.5 * h[:, None] * (integ[:-1] + integ[1:])  # [nlayers-1, wave]
    idx = jnp.arange(nlayers - 1)[:, None]
    mask = (idx >= itop) & (idx < ideep[None, :])
    integral = jnp.sum(jnp.where(mask, terms, 0.0), axis=0)
    return (radius[itop] ** 2 + 2.0 * integral) / rstar**2


def plane_parallel_depth(ec, radius, maxdepth=np.inf, itop=0, ibottom=None):
    """Vertical optical depth for plane-parallel (emission) geometry.

    depth[k] = cumulative trapezoid of ec over the layer thicknesses,
    zero at and above itop.  Reference: _trapezoid.c:175-213.

    Returns (depth [nlayers, nwave], ideep [nwave]).
    """
    nlayers, nwave = ec.shape
    if ibottom is None:
        ibottom = nlayers
    radius = jnp.asarray(radius)
    dr = radius[:-1] - radius[1:]                       # positive intervals
    steps = 0.5 * dr[:, None] * (ec[1:] + ec[:-1])      # step into layer k+1
    rows = jnp.arange(nlayers)
    step_mask = (rows[1:] > itop)[:, None]
    csum = jnp.cumsum(jnp.where(step_mask, steps, 0.0), axis=0)
    depth = jnp.concatenate([jnp.zeros((1, nwave)), csum], axis=0)
    depth = jnp.where((rows > itop)[:, None], depth, 0.0)

    stop = (depth >= maxdepth) & (rows > itop)[:, None]
    any_stop = jnp.any(stop, axis=0)
    first_stop = jnp.argmax(stop, axis=0)
    bottom = jnp.minimum(ibottom, nlayers - 1)
    ideep = jnp.where(any_stop, jnp.minimum(first_stop, bottom), bottom)
    return depth, ideep


def gauss_quadrature(nquad):
    """Gauss-Legendre nodes mapped to mu = cos(theta) over a hemisphere.

    Returns (mu [nquad], weights [nquad]) such that
    flux = sum_k weights[k] * I(mu[k]) approximates
    pi * integral I(mu) mu dmu (reference pyrat/spectrum.py:42-64).
    """
    qnodes, qweights = ss.roots_legendre(nquad)
    qnodes = 0.5 * (qnodes + 1.0)
    mu = np.sqrt(qnodes)
    weights = 0.5 * np.pi * qweights
    return mu, weights


def plane_parallel_intensity(depth, bbody, mu, ideep, rtop=0):
    """Emergent intensity I(mu) under plane-parallel LTE.

    I = B[last] e^{-tau_max/mu} - integral B d(e^{-tau/mu}) from rtop to
    last=ideep (per wavelength), via masked trapezoid.  When the
    integration column has a single interval the reference short-circuits
    to I = B[last] (_trapezoid.c:304-341).

    Parameters
    ----------
    depth: [nlayers, nwave]; bbody: [nlayers, nwave]; mu: [nmu].

    Returns
    -------
    intensity: [nmu, nwave].
    """
    nlayers, nwave = depth.shape
    mu = jnp.asarray(mu)[:, None]                         # [nmu, 1]
    lay = jnp.arange(nlayers)

    taumax = jnp.take_along_axis(depth, ideep[None, :], axis=0)[0]  # [wave]
    b_last = jnp.take_along_axis(bbody, ideep[None, :], axis=0)[0]

    # d(exp(-tau/mu)) between consecutive layers, per mu: [nmu, nl-1, nw]
    etau = jnp.exp(-depth[None, :, :] / mu[:, :, None])   # [nmu, lay, wave]
    dtau = etau[:, 1:, :] - etau[:, :-1, :]
    b_mid = (bbody[1:] + bbody[:-1])[None, :, :]
    mask = (
        (lay[:-1, None] >= rtop) & (lay[:-1, None] < ideep[None, :])
    )[None, :, :]
    integral = 0.5 * jnp.sum(jnp.where(mask, dtau * b_mid, 0.0), axis=1)

    intensity = b_last[None, :] * jnp.exp(-taumax / mu) - integral
    single = (ideep - rtop) == 1
    return jnp.where(single[None, :], b_last[None, :], intensity)


def two_stream(depth, bbody, wn, flux_down_top, f_int):
    """Heng et al. (2014) two-stream up/down fluxes through each layer.

    Parameters
    ----------
    depth: [nlayers, nwave] optical depth (no early stop).
    bbody: [nlayers, nwave] Planck function at layer temperatures.
    wn: [nwave] wavenumber (cm-1).
    flux_down_top: [nwave] downward stellar irradiation at the top.
    f_int: [nwave] internal heat flux, normalized to sigma*Tint^4.

    Returns
    -------
    flux_up, flux_down: [nlayers, nwave].
    Reference: pyrat/spectrum.py:454-523 (sequential recurrences ->
    lax.scan here).
    """
    from ..ops.special import exp1
    nlayers, nwave = depth.shape
    dtau0 = depth[1:] - depth[:-1]
    # Transmission with diffusivity (Heng et al. 2014, eq. B5):
    safe_dtau = jnp.where(dtau0 > 0, dtau0, 1.0)
    trans = (1.0 - dtau0) * jnp.exp(-dtau0) + dtau0**2 * jnp.where(
        dtau0 > 0, exp1(safe_dtau), 0.0,
    )
    bp = (bbody[1:] - bbody[:-1]) / jnp.where(dtau0 == 0, 1.0, dtau0)

    one_m_etau = -jnp.expm1(-dtau0)

    # Downward sweep:
    def down_step(fdown, layer):
        trans_i, b_i, bp_i, dtau_i, ometau_i = layer
        fnext = (
            trans_i * fdown
            + np.pi * b_i * (1.0 - trans_i)
            + np.pi * bp_i * (
                -2.0 / 3.0 * ometau_i + dtau_i * (1.0 - trans_i / 3.0))
        )
        return fnext, fnext

    layers_down = (trans, bbody[:-1], bp, dtau0, one_m_etau)
    _, fdown_rest = lax.scan(down_step, flux_down_top, layers_down)
    flux_down = jnp.concatenate([flux_down_top[None, :], fdown_rest], axis=0)

    # Upward sweep (bottom boundary: down flux + internal flux):
    fup_bottom = flux_down[-1] + f_int

    def up_step(fup, layer):
        trans_i, b_ip1, bp_i, dtau_i, ometau_i = layer
        fprev = (
            trans_i * fup
            + np.pi * b_ip1 * (1.0 - trans_i)
            + np.pi * bp_i * (
                2.0 / 3.0 * ometau_i - dtau_i * (1.0 - trans_i / 3.0))
        )
        return fprev, fprev

    layers_up = (trans, bbody[1:], bp, dtau0, one_m_etau)
    _, fup_rest = lax.scan(up_step, fup_bottom, layers_up, reverse=True)
    flux_up = jnp.concatenate([fup_rest, fup_bottom[None, :]], axis=0)
    return flux_up, flux_down


def internal_flux(wn, tint):
    """Internal heat flux spectrum normalized to sigma*Tint^4 bolometric."""
    f_int = blackbody_wn(jnp.asarray(wn), tint)
    total = jnp.trapezoid(f_int, jnp.asarray(wn))
    scale = jnp.where(total > 0, pc.sigma_sb * tint**4 / total, 0.0)
    return f_int * scale
