"""Contribution functions and transmittance diagnostics.

Reference behavior: pyratbay/spectrum/contribution_funcs.py.
"""
import jax
import jax.numpy as jnp

__all__ = ['contribution_function', 'transmittance', 'band_cf']


def contribution_function(optdepth, pressure, bbody):
    """Emission contribution function, Knutson et al. (2009) eq. (2).

    cf[i] = B[i] * d(e^-tau)/dln(p), normalized per wavelength.
    """
    detau = jnp.diff(jnp.exp(-optdepth), axis=0)
    detau = jnp.where(detau > 0.1, 0.0, detau)
    dlogp = jnp.diff(jnp.log(jnp.asarray(pressure)))
    cf = bbody[:-1] * detau / dlogp[:, None]
    cf = jnp.concatenate([cf, jnp.zeros((1, cf.shape[1]))], axis=0)
    return cf / jnp.sum(cf, axis=0)


def transmittance(optdepth, ideep):
    """Transit transmittance e^-tau, opaque (0) below the ideep layer."""
    nlayers = optdepth.shape[0]
    lay = jnp.arange(nlayers)[:, None]
    transmit = jnp.exp(-optdepth)
    return jnp.where(lay >= ideep[None, :], 0.0, transmit)


def band_cf(cf, band_weight_matrix):
    """Band-averaged contribution functions.

    band_weight_matrix: [nbands, nwave] trapezoid weight rows over each
    band's response (unnormalized is fine; output is max-normalized).
    Returns [nlayers, nbands].
    """
    bands_cf = jnp.matmul(cf, band_weight_matrix.T,
                          precision=jax.lax.Precision.HIGHEST)
    return bands_cf / jnp.max(bands_cf, axis=0)
