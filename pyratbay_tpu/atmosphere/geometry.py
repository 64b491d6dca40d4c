"""Ray-path geometry for transit (limb) observations.

The reference builds a ragged list of per-impact-parameter chord segments
(pyratbay/atmosphere/atmosphere.py:737-802) consumed by per-layer C loops.
Here the geometry is one dense lower-triangular matrix so the optical
depth becomes a single matmul over the wavelength axis.
"""
import jax.numpy as jnp

__all__ = ['transit_path_matrix']


def transit_path_matrix(radius, itop=0):
    """Dense chord-segment matrix for transit geometry.

    For a ray with impact parameter radius[r], the distance traveled
    through the shell between layers i and i+1 is
        path[r, i] = sqrt(radius[i]^2 - radius[r]^2)
                   - sqrt(radius[i+1]^2 - radius[r]^2),   for itop <= i < r,
    and 0 elsewhere.  radius must be sorted from top (largest) to bottom.

    Returns
    -------
    path: [nlayers, nlayers-1] array (row r = impact parameter, col i =
        shell index).  Strictly lower-triangular with the itop cutoff.
    """
    radius = jnp.asarray(radius)
    nlayers = radius.shape[0]
    r2 = radius**2
    # s[r, i] = sqrt(max(r2[i] - r2[r], 0))
    diff_outer = r2[None, :] - r2[:, None]   # [r, i]
    s = jnp.sqrt(jnp.maximum(diff_outer, 0.0))
    seg = s[:, :-1] - s[:, 1:]               # [r, i] for i in [0, nlayers-2]
    rows = jnp.arange(nlayers)[:, None]
    cols = jnp.arange(nlayers - 1)[None, :]
    mask = (cols < rows) & (cols >= itop) & (rows > itop)
    return jnp.where(mask, seg, 0.0)
