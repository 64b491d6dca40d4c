"""The ensemble transit kernel compiled for the GPU (no interpreter)
== its XLA reference, in float32.  Skips without a GPU; on the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

chip_smoke.py runs the same comparison at the flagship width.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyratbay_tpu.atmosphere.geometry import transit_path_matrix
from pyratbay_tpu.spectrum.ensemble_pallas import (
    transit_spectrum_ensemble, transit_spectrum_reference,
)


@pytest.mark.gpu
@pytest.mark.parametrize('nlayers, nwave', [(51, 3209), (16, 129)])
def test_kernel_matches_reference_on_gpu(gpu, nlayers, nwave):
    rng = np.random.default_rng(0)
    nb, ncia = 64, 7
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    radius = np.sort(rng.uniform(1.0, 1.1, (nb, nlayers)), axis=1)[:, ::-1]
    scale = np.exp(np.linspace(0, 6, nlayers))[None, :, None]
    ec = rng.lognormal(-3.0, 2.0, (nb, nlayers, nwave)) * scale
    itop = np.arange(nb) % 3
    deck_itop = nlayers - 1 - np.arange(nb) % 7
    deck_rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
        radius[np.arange(nb), deck_itop - 1]
        - radius[np.arange(nb), deck_itop])
    path = jax.vmap(transit_path_matrix)(f32(radius), jnp.asarray(itop))
    args = ([f32(ec)], path, f32(radius), 12.0, jnp.asarray(itop),
            jnp.asarray(deck_itop + 1))
    kw = dict(
        deck_itop=jnp.asarray(deck_itop), deck_rsurf=f32(deck_rsurf),
        cia_w=f32(rng.lognormal(-1.0, 0.5, (nb, nlayers, ncia))),
        cia_tab=np.asarray(rng.lognormal(-2.0, 1.0, (ncia, nwave)),
                           np.float32),
        r1_cols=f32(rng.lognormal(-2.0, 1.0, (nb, 2, nlayers))),
        r1_rows=f32(rng.lognormal(-1.0, 1.0, (nb, 2, nwave))),
        maxdepth=8.0,
    )
    fn = jax.jit(lambda *a: transit_spectrum_ensemble(*a, **kw))
    assert 'triton' in fn.lower(*args).as_text().lower()
    got = np.asarray(fn(*args))
    ref = np.asarray(jax.jit(
        lambda *a: transit_spectrum_reference(*a, **kw))(*args))
    err = np.max(np.abs(got - ref), axis=1) / np.max(np.abs(ref), axis=1)
    assert err.max() <= 2e-5
