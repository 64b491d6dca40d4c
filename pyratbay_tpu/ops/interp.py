"""Interpolation primitives.

Two flavors live here:
  * Host-side (numpy) natural-cubic-spline resampling used once at model
    setup (e.g. resampling CIA tables onto the working wavenumber grid).
  * Device-side (JAX) linear interpolation used inside the jitted forward
    model (e.g. temperature interpolation of tabulated cross sections).

Reference behavior: src_c/_spline.c.  Note that the reference's
`second_deriv` computes the spline tension term as
    sig = (x[i]-x[i-1]) / (x[i+1] - y[i-1])
mixing the y array into the denominator (an apparent typo for x[i-1];
src_c/_spline.c:50-51).  `second_deriv_ref` reproduces that exact behavior
because the published golden spectra were generated with it;
`second_deriv` implements the textbook natural spline.
"""
import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    'second_deriv',
    'second_deriv_ref',
    'splinterp',
    'lin_interp_trow',
]


def _second_deriv_impl(y, x, ref_quirk):
    """Natural cubic-spline second derivatives (host-side numpy)."""
    y = np.asarray(y, float)
    x = np.asarray(x, float)
    n = len(y) - 1
    y2 = np.zeros(n + 1)
    u = np.zeros(n)
    for i in range(1, n):
        denom = (x[i + 1] - y[i - 1]) if ref_quirk else (x[i + 1] - x[i - 1])
        sig = (x[i] - x[i - 1]) / denom
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        ui = (
            (y[i + 1] - y[i]) / (x[i + 1] - x[i])
            - (y[i] - y[i - 1]) / (x[i] - x[i - 1])
        )
        u[i] = (6.0 * ui / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for i in range(n - 1, -1, -1):
        y2[i] = y2[i] * y2[i + 1] + u[i]
    y2[n] = 0.0
    return y2


def second_deriv(y, x):
    """Textbook natural-cubic-spline second derivatives."""
    return _second_deriv_impl(y, x, ref_quirk=False)


def second_deriv_ref(y, x):
    """Reference-compatible second derivatives (see module docstring)."""
    return _second_deriv_impl(y, x, ref_quirk=True)


def splinterp(y, x, y2, xout, extrap=0.0):
    """Cubic-spline interpolation of y(x) at xout (host-side numpy).

    Points outside [x[0], x[-1]] get the `extrap` value.
    """
    y = np.asarray(y, float)
    x = np.asarray(x, float)
    xout = np.asarray(xout, float)
    yout = np.full(len(xout), extrap, float)
    inside = (xout >= x[0]) & (xout <= x[-1])
    idx = np.searchsorted(x, xout[inside], side='right') - 1
    idx = np.clip(idx, 0, len(x) - 2)
    dx = x[idx + 1] - x[idx]
    a = (x[idx + 1] - xout[inside]) / dx
    b = (xout[inside] - x[idx]) / dx
    yout[inside] = (
        a * y[idx] + b * y[idx + 1]
        + ((a**3 - a) * y2[idx] + (b**3 - b) * y2[idx + 1]) * dx * dx / 6.0
    )
    return yout


def lin_interp_trow(table, xin, dy_dx, xout, lo=0, hi=None):
    """Linear interpolation of a [nx, ncol] table along axis 0 (JAX).

    For each value in `xout` (e.g. a temperature profile) interpolate
    each column of `table` linearly, using precomputed slopes `dy_dx`
    (shape [nx-1, ncol]).  Columns outside [lo, hi) return 0, matching
    the reference semantics where the table does not cover those
    wavenumbers (src_c/_spline.c:219-260).  Out-of-range xout values are
    clamped (range validity must be enforced by the caller; clamping
    keeps this jit-safe).

    Returns array of shape [len(xout), ncol].
    """
    table = jnp.asarray(table)
    xin = jnp.asarray(xin)
    xout = jnp.asarray(xout)
    dy_dx = jnp.asarray(dy_dx)
    nx, ncol = table.shape
    if hi is None:
        hi = ncol
    idx = jnp.clip(jnp.searchsorted(xin, xout, side='right') - 1, 0, nx - 2)
    deltax = xout - xin[idx]
    # Row selection as a dense contraction over the (small) x axis
    # instead of a row gather: under vmap over retrieval chains the
    # gather re-reads [len(xout), ncol] rows per chain, while the
    # einsum reads the table once.  The 0/1
    # selection weights make this bit-identical to table[idx].
    sel = (
        jnp.arange(nx)[:, None] == idx[None, :]
    ).astype(table.dtype)                              # [nx, nout]
    base = jnp.einsum('xX,xc->Xc', sel, table,
                      precision=jax.lax.Precision.HIGHEST)
    slope = jnp.einsum('xX,xc->Xc', sel[:nx - 1], dy_dx,
                       precision=jax.lax.Precision.HIGHEST)
    out = base + deltax[:, None] * slope
    # On exact-grid hits the reference takes the row as-is; linear interp
    # with deltax=0 gives the same result, so no special case is needed.
    col = jnp.arange(ncol)
    in_range = (col >= lo) & (col < hi)
    return jnp.where(in_range[None, :], out, 0.0)
