"""Ensemble transit kernel (Pallas Triton, in the interpreter) == the
per-chain XLA path: layer padding to a power of two, the wave-tail
mask, batched deck splice, CIA and rank-1 operands, maxdepth stops,
and the platform choice of the wrapper.  The kernel itself compiles
only for a GPU; chip_smoke.py checks it there.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyratbay_tpu.atmosphere.geometry import transit_path_matrix
from pyratbay_tpu.spectrum import rt
from pyratbay_tpu.spectrum import ensemble_pallas as ens
from pyratbay_tpu.spectrum.ensemble_pallas import (
    transit_spectrum_ensemble, transit_spectrum_reference,
)


def _setup(nb=5, nlayers=40, nwave=300, ncia=7, seed=0):
    rng = np.random.default_rng(seed)
    radius = np.sort(
        rng.uniform(1.0, 1.1, (nb, nlayers)), axis=1)[:, ::-1].copy()
    ec1 = rng.lognormal(-3.0, 2.0, (nb, nlayers, nwave))
    ec1 *= np.exp(np.linspace(0, 6, nlayers))[None, :, None]
    ec2 = rng.lognormal(-4.0, 1.5, (nb, nlayers, nwave))
    cia_tab = rng.lognormal(-2.0, 1.0, (ncia, nwave))
    cia_w = rng.lognormal(-1.0, 0.5, (nb, nlayers, ncia))
    return (jnp.asarray(ec1), jnp.asarray(ec2), jnp.asarray(radius),
            jnp.asarray(cia_w), cia_tab)


def _paths(radius, itop):
    return jnp.stack([
        transit_path_matrix(radius[b], itop[b])
        for b in range(radius.shape[0])
    ])


def _per_chain(ec, path, radius, rstar, itop, ibottom, maxdepth,
               deck_itop=None, deck_rsurf=None):
    out = []
    for b in range(ec.shape[0]):
        depth, ideep = rt.transit_depth(
            ec[b], path[b], maxdepth, itop[b], ibottom[b],
        )
        out.append(np.asarray(rt.transmission_spectrum(
            depth, ideep, radius[b], rstar, itop[b],
            deck_rsurf=None if deck_rsurf is None else deck_rsurf[b],
            deck_itop=None if deck_itop is None else deck_itop[b],
        )))
    return np.stack(out)


@pytest.mark.parametrize('nlayers, nwave', [
    (40, 300),    # layers pad 40 -> 64, wave tail of 44 points
    (51, 256),    # the flagship depth; wave an exact tile multiple
    (16, 129),    # no layer padding; one-point wave tail
])
def test_ensemble_matches_per_chain(nlayers, nwave):
    nb = 5
    ec1, ec2, radius, cia_w, cia_tab = _setup(nb, nlayers, nwave)
    rstar = 12.0
    maxdepth = 8.0
    itop = jnp.asarray([0, 1, 0, 2, 0])
    deck_itop = jnp.asarray(
        [nlayers - 5, nlayers - 10, nlayers - 1, nlayers // 2,
         nlayers - 7])
    deck_rsurf = jnp.asarray([
        float(radius[b, deck_itop[b]])
        + 0.4 * (float(radius[b, deck_itop[b] - 1])
                 - float(radius[b, deck_itop[b]]))
        for b in range(nb)
    ])
    ibottom = deck_itop + 1
    path = _paths(radius, itop)
    got = np.asarray(transit_spectrum_ensemble(
        [ec1, ec2], path, radius, rstar, itop, ibottom,
        deck_itop=deck_itop, deck_rsurf=deck_rsurf,
        cia_w=cia_w, cia_tab=cia_tab, maxdepth=maxdepth, interpret=True,
    ))
    cia_ec = jnp.einsum('blt,tw->blw', cia_w, jnp.asarray(cia_tab))
    ref = _per_chain(ec1 + ec2 + cia_ec, path, radius, rstar, itop,
                     ibottom, maxdepth, deck_itop, deck_rsurf)
    assert got.shape == (nb, nwave)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize('maxdepth', [np.inf, 10.0, 1.0])
def test_ensemble_no_cia_no_deck(maxdepth):
    nb, nlayers = 3, 40
    ec1, _, radius, _, _ = _setup(nb, nlayers, seed=2)
    itop = jnp.zeros(nb, int)
    ibottom = jnp.full((nb,), nlayers)
    path = _paths(radius, itop)
    got = np.asarray(transit_spectrum_ensemble(
        [ec1], path, radius, 10.0, itop, ibottom,
        maxdepth=maxdepth, interpret=True,
    ))
    ref = _per_chain(ec1, path, radius, 10.0, itop, ibottom, maxdepth)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize('with_dense', [True, False])
def test_transit_ensemble_rank1_parts(with_dense):
    """Rank-1 (layer column x wave row) parts == the dense outer
    product passed as an ec part, including the no-dense-part case."""
    rng = np.random.default_rng(37)
    nb, nl, nw = 5, 24, 300
    radius = (np.linspace(1.1, 1.0, nl)[None, :]
              * (1 + 0.01 * rng.standard_normal((nb, 1))))
    paths = _paths(jnp.asarray(radius), np.zeros(nb, int))
    ec = rng.lognormal(-3.0, 1.5, (nb, nl, nw)) \
        * np.exp(np.linspace(0, 6, nl))[None, :, None]
    cols = rng.lognormal(0.0, 1.0, (nb, 2, nl))
    rows = rng.lognormal(-1.0, 1.0, (nb, 2, nw))
    dense = np.einsum('brl,brw->blw', cols, rows)
    base = ec if with_dense else np.zeros_like(ec)

    common = dict(maxdepth=8.0, interpret=True)
    args = (paths, jnp.asarray(radius), 12.0, jnp.zeros(nb, int),
            jnp.full(nb, nl))
    ref = np.asarray(transit_spectrum_ensemble(
        [jnp.asarray(base + dense)], *args, **common,
    ))
    got = np.asarray(transit_spectrum_ensemble(
        [jnp.asarray(ec)] if with_dense else [], *args,
        r1_cols=jnp.asarray(cols), r1_rows=jnp.asarray(rows), **common,
    ))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_reference_matches_interpreted_kernel():
    """The XLA reference (what non-GPU platforms lower) and the kernel
    agree on the full operand set."""
    nb, nlayers = 4, 30
    ec1, ec2, radius, cia_w, cia_tab = _setup(nb, nlayers, 200, seed=5)
    rng = np.random.default_rng(6)
    cols = jnp.asarray(rng.lognormal(0.0, 1.0, (nb, 1, nlayers)))
    rows = jnp.asarray(rng.lognormal(-1.0, 1.0, (nb, 1, 200)))
    itop = jnp.asarray([0, 3, 1, 0])
    args = ([ec1, ec2], _paths(radius, itop), radius, 9.0, itop,
            jnp.full(nb, nlayers))
    kw = dict(cia_w=cia_w, cia_tab=cia_tab, r1_cols=cols, r1_rows=rows,
              maxdepth=6.0)
    got = np.asarray(transit_spectrum_ensemble(*args, interpret=True,
                                               **kw))
    ref = np.asarray(transit_spectrum_reference(*args, **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_cpu_lowering_takes_the_reference():
    """Off the GPU, the wrapper lowers the XLA reference: no Triton
    call reaches the CPU program, and the result is the reference's."""
    nb, nlayers = 3, 20
    ec1, _, radius, _, _ = _setup(nb, nlayers, 150, seed=8)
    itop = jnp.zeros(nb, int)
    args = ([ec1], _paths(radius, itop), radius, 10.0, itop,
            jnp.full(nb, nlayers))
    fn = jax.jit(lambda *a: transit_spectrum_ensemble(*a, maxdepth=5.0))
    assert 'triton' not in fn.lower(*args).as_text().lower()
    ref = transit_spectrum_reference(*args, maxdepth=5.0)
    np.testing.assert_allclose(np.asarray(fn(*args)), np.asarray(ref),
                               rtol=1e-12)


@pytest.mark.parametrize('n, expected', [
    (1, 16), (7, 16), (16, 16), (17, 32), (51, 64), (64, 64), (65, 128),
])
def test_block_sizes_are_powers_of_two(n, expected):
    assert ens._pow2(n) == expected
