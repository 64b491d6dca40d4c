"""Integration primitives (trapezoid / Simpson) as vectorized JAX ops.

The reference does these in per-wavelength C loops (src_c/_trapezoid.c,
src_c/_simpson.c); here they are dense array ops so XLA can fuse them.
"""
import jax.numpy as jnp

__all__ = [
    'trapz_intervals',
    'cumtrapz',
    'simpson_nonuniform',
]


def trapz_intervals(data, intervals, axis=0):
    """Trapezoid integral given pre-computed intervals between samples.

    integral = 0.5 * sum_i intervals[i] * (data[i+1] + data[i])
    """
    data = jnp.moveaxis(data, axis, 0)
    mids = data[1:] + data[:-1]
    shape = (-1,) + (1,) * (mids.ndim - 1)
    return 0.5 * jnp.sum(mids * intervals.reshape(shape), axis=0)


def cumtrapz(y, x, axis=0, initial=0.0):
    """Cumulative trapezoid integral along `axis`, starting at `initial`."""
    y = jnp.moveaxis(y, axis, 0)
    x = jnp.moveaxis(jnp.broadcast_to(x, y.shape), 0, 0)
    dx = x[1:] - x[:-1]
    steps = 0.5 * dx * (y[1:] + y[:-1])
    csum = jnp.concatenate(
        [jnp.full_like(steps[:1], initial), jnp.cumsum(steps, axis=0)], axis=0,
    )
    return jnp.moveaxis(csum, 0, axis)


def simpson_nonuniform(y, x=None, dx=None, axis=0):
    """Composite Simpson integral on (possibly) non-uniform samples.

    Matches scipy.integrate.simpson semantics (and the reference's
    src_c/_simpson.c port of it): for an even number of intervals uses
    pure Simpson; for odd, the final interval is handled with the
    asymmetric 3-point correction.
    """
    y = jnp.moveaxis(y, axis, 0)
    n = y.shape[0]
    if x is not None:
        h = jnp.diff(jnp.asarray(x))
    else:
        h = jnp.full((n - 1,), 1.0 if dx is None else dx)

    def pair_contrib(h0, h1, y0, y1, y2):
        hsum = h0 + h1
        hprod = h0 * h1
        h0div = h0 / jnp.where(h1 == 0, 1.0, h1)
        return (hsum / 6.0) * (
            y0 * (2.0 - 1.0 / jnp.where(h0div == 0, 1.0, h0div))
            + y1 * hsum * hsum / jnp.where(hprod == 0, 1.0, hprod)
            + y2 * (2.0 - h0div)
        )

    npairs = (n - 1) // 2
    total = 0.0
    if npairs > 0:
        h0 = h[0:2 * npairs:2]
        h1 = h[1:2 * npairs:2]
        shape = (-1,) + (1,) * (y.ndim - 1)
        contrib = pair_contrib(
            h0.reshape(shape), h1.reshape(shape),
            y[0:2 * npairs:2], y[1:2 * npairs:2], y[2:2 * npairs + 1:2],
        )
        total = jnp.sum(contrib, axis=0)

    if (n - 1) % 2 == 1:  # odd number of intervals: correction for last one
        h1 = h[-1]
        h0 = h[-2] if n >= 3 else h[-1]
        alpha = (2 * h1**2 + 3 * h0 * h1) / (6 * (h0 + h1))
        beta = (h1**2 + 3 * h0 * h1) / (6 * h0)
        eta = h1**3 / (6 * h0 * (h0 + h1))
        total = total + alpha * y[-1] + beta * y[-2] - eta * y[-3]
    return total
