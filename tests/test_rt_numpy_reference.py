"""The plain XLA radiative transfer against independent float64 numpy
loops written from the reference's C semantics
(src_c/_trapezoid.c: optdepth, trapezoid2D, the plane-parallel
intensity integral): transit with the maxdepth early stop, a raised
top row, the cloud-deck splice and summed opacity operands; emission
with the early stop, a raised top row, the deck blackbody surface and
the single-interval short cut.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import pyratbay_tpu.constants as pc
from pyratbay_tpu.atmosphere.geometry import transit_path_matrix
from pyratbay_tpu.ops.planck import blackbody_wn
from pyratbay_tpu.spectrum import rt
from pyratbay_tpu.spectrum.ensemble_pallas import (
    dense_extinction, transit_spectrum_reference,
)


# ---------------------------------------------------------------------
# numpy references

def np_transit(ec, radius, rstar, itop, ibottom, maxdepth,
               deck_itop=None, deck_rsurf=None):
    """(Rp/Rs)^2: optical depth per impact parameter from the half-chord
    segments, first layer past maxdepth, then the trapezoid of
    exp(-tau) r dr down to that layer."""
    nlayers, nwave = ec.shape
    r = np.asarray(radius, float)
    depth = np.zeros((nlayers, nwave))
    ideep = np.full(nwave, ibottom - 1)
    found = np.zeros(nwave, bool)
    for i in range(itop, ibottom):
        tau = np.zeros(nwave)
        for j in range(itop, i):
            seg = (np.sqrt(r[j]**2 - r[i]**2)
                   - np.sqrt(r[j + 1]**2 - r[i]**2))
            tau += seg * (ec[j] + ec[j + 1])
        depth[i] = tau
        new = ~found & (tau > maxdepth)
        ideep[new] = i
        found |= new
    integ = np.exp(-depth) * r[:, None]
    h = r[1:] - r[:-1]
    if deck_itop is not None and deck_itop > itop:
        j = deck_itop - 1
        w = (r[j] - deck_rsurf) / (r[j] - r[j + 1])
        integ[deck_itop] = integ[j] * (1 - w) + integ[j + 1] * w
        h[j] = deck_rsurf - r[j]
    spec = np.empty(nwave)
    for w in range(nwave):
        total = 0.0
        for i in range(itop, ideep[w]):
            total += 0.5 * h[i] * (integ[i, w] + integ[i + 1, w])
        spec[w] = (r[itop]**2 + 2.0 * total) / rstar**2
    return spec


def np_planck(wn, temp):
    c1 = 2.0 * pc.H_KERNEL * pc.LS_KERNEL**2
    c2 = pc.H_KERNEL * pc.LS_KERNEL / pc.KB_KERNEL
    return c1 * wn**3 / np.expm1(c2 * wn / temp)


def np_emission(ec, radius, temp, wn, mu, weights, maxdepth, rtop,
                ibottom, deck_itop=None, deck_tsurf=None):
    """Plane-parallel flux: cumulative-trapezoid depth below rtop,
    per-wavenumber bottom layer (first tau >= maxdepth, else the
    bottom), I(mu) = B_last e^{-tau_last/mu} - int B d e^{-tau/mu}."""
    nlayers, nwave = ec.shape
    depth = np.zeros((nlayers, nwave))
    for k in range(rtop + 1, nlayers):
        depth[k] = depth[k - 1] + 0.5 * (radius[k - 1] - radius[k]) * (
            ec[k] + ec[k - 1])
    bottom = min(ibottom, nlayers - 1)
    ideep = np.full(nwave, bottom)
    for w in range(nwave):
        stop = np.nonzero(depth[rtop + 1:, w] >= maxdepth)[0]
        if len(stop):
            ideep[w] = min(rtop + 1 + stop[0], bottom)
    bbody = np_planck(wn[None, :], temp[:, None])
    if deck_itop is not None:
        bbody[deck_itop] = np_planck(wn, deck_tsurf)
        ideep = np.minimum(ideep, deck_itop)
    flux = np.zeros(nwave)
    for m, weight in zip(mu, weights):
        for w in range(nwave):
            last = ideep[w]
            if last - rtop == 1:
                flux[w] += weight * bbody[last, w]
                continue
            et = np.exp(-depth[:, w] / m)
            integral = sum(
                0.5 * (bbody[k + 1, w] + bbody[k, w]) * (et[k + 1] - et[k])
                for k in range(rtop, last)
            )
            flux[w] += weight * (bbody[last, w] * et[last] - integral)
    return flux


# ---------------------------------------------------------------------
# transit

def _transit_setup(nlayers=51, nwave=120, seed=0):
    rng = np.random.default_rng(seed)
    radius = np.linspace(1.10, 1.00, nlayers)
    ec = rng.lognormal(-3.0, 2.0, (nlayers, nwave))
    ec *= np.exp(np.linspace(0, 8, nlayers))[:, None]
    return ec, radius


def _xla_transit(ec, radius, rstar, itop, ibottom, maxdepth,
                 deck_itop=None, deck_rsurf=None):
    path = transit_path_matrix(jnp.asarray(radius), itop)
    depth, ideep = rt.transit_depth(
        jnp.asarray(ec), path, maxdepth, itop, ibottom)
    return np.asarray(rt.transmission_spectrum(
        depth, ideep, jnp.asarray(radius), rstar, itop,
        deck_rsurf=deck_rsurf, deck_itop=deck_itop,
    ))


@pytest.mark.parametrize('case', [
    dict(maxdepth=np.inf),
    dict(maxdepth=10.0),
    dict(maxdepth=1.0),
    dict(maxdepth=10.0, itop=3),
    dict(maxdepth=10.0, deck_itop=30, frac=0.4),
    dict(maxdepth=10.0, itop=5, deck_itop=2, frac=0.3),  # deck above top
])
def test_transit_matches_numpy(case):
    ec, radius = _transit_setup(seed=len(case))
    itop = case.get('itop', 0)
    deck_itop = case.get('deck_itop')
    deck_rsurf = None
    ibottom = 51
    if deck_itop is not None:
        deck_rsurf = radius[deck_itop] + case['frac'] * (
            radius[deck_itop - 1] - radius[deck_itop])
        ibottom = deck_itop + 1 if deck_itop > itop else 51
    got = _xla_transit(ec, radius, 12.0, itop, ibottom,
                       case['maxdepth'], deck_itop, deck_rsurf)
    ref = np_transit(ec, radius, 12.0, itop, ibottom, case['maxdepth'],
                     deck_itop, deck_rsurf)
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    if deck_itop is not None and deck_itop > itop:
        # ... and the splice changes the answer:
        base = np_transit(ec, radius, 12.0, itop, 51, case['maxdepth'])
        assert not np.allclose(ref, base)


@pytest.mark.parametrize('with_deck', [False, True])
def test_transit_summed_parts_match_numpy(with_deck):
    """Dense parts + rank-1 pairs + CIA weights, composed by the
    ensemble XLA reference, == numpy on the summed extinction."""
    rng = np.random.default_rng(17)
    nb, nl, nw, ncia = 3, 30, 90, 5
    radius = (np.linspace(1.1, 1.0, nl)[None, :]
              * (1 + 0.01 * rng.standard_normal((nb, 1))))
    scale = np.exp(np.linspace(0, 6, nl))[None, :, None]
    ec1 = rng.lognormal(-3.0, 1.5, (nb, nl, nw)) * scale
    ec2 = rng.lognormal(-4.0, 1.0, (nb, nl, nw)) * scale
    cols = rng.lognormal(-2.0, 1.0, (nb, 2, nl)) * scale[..., 0][:, None]
    rows = rng.lognormal(-1.0, 1.0, (nb, 2, nw))
    cia_w = rng.lognormal(-3.0, 0.5, (nb, nl, ncia)) * scale
    cia_tab = rng.lognormal(-1.0, 1.0, (ncia, nw))
    itop = np.array([0, 2, 1])
    deck_itop = np.array([25, 20, 28]) if with_deck else None
    deck_rsurf = None
    ibottom = np.full(nb, nl)
    if with_deck:
        deck_rsurf = np.array([
            radius[b, deck_itop[b]] + 0.3 * (
                radius[b, deck_itop[b] - 1] - radius[b, deck_itop[b]])
            for b in range(nb)
        ])
        ibottom = deck_itop + 1
    path = np.stack([
        np.asarray(transit_path_matrix(jnp.asarray(radius[b]), itop[b]))
        for b in range(nb)
    ])
    got = np.asarray(transit_spectrum_reference(
        [jnp.asarray(ec1), jnp.asarray(ec2)], jnp.asarray(path),
        jnp.asarray(radius), 9.0, jnp.asarray(itop), jnp.asarray(ibottom),
        deck_itop=None if deck_itop is None else jnp.asarray(deck_itop),
        deck_rsurf=None if deck_rsurf is None else jnp.asarray(deck_rsurf),
        cia_w=jnp.asarray(cia_w), cia_tab=cia_tab,
        r1_cols=jnp.asarray(cols), r1_rows=jnp.asarray(rows),
        maxdepth=8.0,
    ))
    ec = (ec1 + ec2 + np.einsum('brl,brw->blw', cols, rows)
          + np.einsum('blk,kw->blw', cia_w, cia_tab))
    for b in range(nb):
        ref = np_transit(
            ec[b], radius[b], 9.0, itop[b], ibottom[b], 8.0,
            None if deck_itop is None else deck_itop[b],
            None if deck_rsurf is None else deck_rsurf[b],
        )
        np.testing.assert_allclose(got[b], ref, rtol=1e-10,
                                   err_msg=f'chain {b}')


# ---------------------------------------------------------------------
# emission

def _emission_setup(nlayers=30, nwave=60, seed=0):
    rng = np.random.default_rng(seed)
    radius = np.linspace(7.2e9, 7.0e9, nlayers)
    temp = 1200 + 500 * rng.random(nlayers)
    ec = rng.lognormal(-25.0, 2.0, (nlayers, nwave))
    ec *= np.exp(np.linspace(0, 10, nlayers))[:, None]
    wn = np.linspace(2000.0, 9000.0, nwave)
    mu, weights = rt.gauss_quadrature(4)
    return ec, radius, temp, wn, mu, weights


def _xla_emission(ec, radius, temp, wn, mu, weights, maxdepth, rtop,
                  ibottom, deck_itop=None, deck_tsurf=None):
    """Model._run_emission's math for one chain."""
    depth, ideep = rt.plane_parallel_depth(
        jnp.asarray(ec), jnp.asarray(radius), maxdepth, rtop, ibottom,
    )
    bbody = blackbody_wn(jnp.asarray(wn), jnp.asarray(temp)[:, None])
    if deck_itop is not None:
        bbody = bbody.at[deck_itop].set(
            blackbody_wn(jnp.asarray(wn), deck_tsurf))
        ideep = jnp.clip(ideep, 0, deck_itop)
    intensity = rt.plane_parallel_intensity(depth, bbody, mu, ideep, rtop)
    return np.asarray(
        jnp.sum(intensity * jnp.asarray(weights)[:, None], axis=0))


@pytest.mark.parametrize('case', [
    dict(maxdepth=np.inf),
    dict(maxdepth=10.0),
    dict(maxdepth=1.0),
    dict(maxdepth=8.0, rtop=2),
    dict(maxdepth=8.0, rtop=5),
    dict(maxdepth=np.inf, deck_itop=20, deck_tsurf=1500.0),
    dict(maxdepth=5.0, deck_itop=12, deck_tsurf=1700.0),
    dict(maxdepth=np.inf, rtop=28),    # one interval: I = B[last]
])
def test_emission_matches_numpy(case):
    ec, radius, temp, wn, mu, weights = _emission_setup(seed=len(case))
    rtop = case.get('rtop', 0)
    deck_itop = case.get('deck_itop')
    deck_tsurf = case.get('deck_tsurf')
    ibottom = 30 if deck_itop is None else deck_itop + 1
    args = (ec, radius, temp, wn, mu, weights, case['maxdepth'], rtop,
            ibottom, deck_itop, deck_tsurf)
    np.testing.assert_allclose(_xla_emission(*args), np_emission(*args),
                               rtol=1e-10)


def test_emission_summed_parts_match_numpy():
    """The eclipse builder's dense composition of its operand classes
    (dense parts, rank-1 pairs, CIA weights) feeds the same flux."""
    ec, radius, temp, wn, mu, weights = _emission_setup(seed=9)
    rng = np.random.default_rng(10)
    nl, nw = ec.shape
    cols = rng.lognormal(-28.0, 1.0, (1, 2, nl))
    rows = rng.lognormal(0.0, 1.0, (1, 2, nw))
    cia_w = rng.lognormal(-28.0, 1.0, (1, nl, 6))
    cia_tab = rng.lognormal(0.0, 1.0, (6, nw))
    composed = np.asarray(dense_extinction(
        [jnp.asarray(0.3 * ec[None]), jnp.asarray(0.7 * ec[None])],
        jnp.asarray(cia_w), cia_tab, jnp.asarray(cols), jnp.asarray(rows),
    ))[0]
    total = (ec + np.einsum('rl,rw->lw', cols[0], rows[0])
             + cia_w[0] @ cia_tab)
    args = (radius, temp, wn, mu, weights, 6.0, 0, nl)
    np.testing.assert_allclose(_xla_emission(composed, *args),
                               np_emission(total, *args), rtol=1e-10)
