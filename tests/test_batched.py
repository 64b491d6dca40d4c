"""Batched ensemble forward == vmap(per-chain forward), f64 CPU.

The batched builder restructures the opacity contractions and RT for
fused ensemble execution (retrieval/batched.py); this pins
its outputs -- spectrum, bandflux, rejection flags, log-posterior --
against the per-chain forward under vmap, including out-of-bounds
parameter vectors.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyratbay_tpu.benchmark import make_flagship
from pyratbay_tpu.retrieval import batched, build_forward, build_log_posterior
from pyratbay_tpu.retrieval.batched import (
    build_forward_batched, build_log_posterior_batched,
)


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('flagship_batched'))
    model, obs, ret, forward, p0 = make_flagship(workdir)
    return model, obs, ret, forward, np.asarray(p0)


def _params(p0, n=6, seed=0):
    rng = np.random.default_rng(seed)
    pb = np.tile(p0, (n, 1)) + 0.05 * rng.standard_normal((n, len(p0)))
    # One out-of-bounds chain (temperature blow-up):
    pb[-1, 1] = 1.0e6
    return jnp.asarray(pb)


def test_batched_matches_vmap(flagship):
    model, obs, ret, forward, p0 = flagship
    forward_b = build_forward_batched(model, obs, ret)
    assert not forward_b.is_fallback

    pb = _params(p0)
    ref = jax.jit(jax.vmap(
        lambda p: {k: forward(p)[k]
                   for k in ('spectrum', 'bandflux', 'good')},
    ))(pb)
    got = jax.jit(forward_b)(pb)

    np.testing.assert_array_equal(
        np.asarray(got['good']), np.asarray(ref['good']))
    assert not bool(np.asarray(ref['good'])[-1])
    np.testing.assert_allclose(
        np.asarray(got['spectrum']), np.asarray(ref['spectrum']),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(got['bandflux'])[:-1], np.asarray(ref['bandflux'])[:-1],
        rtol=1e-10,
    )
    # Rejected chain: +inf bandflux in both:
    assert np.all(np.isinf(np.asarray(got['bandflux'])[-1]))


def test_batched_log_posterior_matches(flagship):
    model, obs, ret, forward, p0 = flagship
    if getattr(model.cfg, 'data', None) is None:
        # Synthesize data so the likelihood exists:
        band = np.asarray(forward(jnp.asarray(p0))['bandflux'])
        obs.data = band * (1 + 1e-4)
        obs.uncert = np.abs(band) * 1e-3 + 1e-12
    log_post = build_log_posterior(model, obs, ret)
    log_post_b = build_log_posterior_batched(model, obs, ret)

    pb = _params(p0, seed=1)
    ref = np.asarray(jax.jit(jax.vmap(log_post))(pb))
    got = np.asarray(jax.jit(log_post_b)(pb))
    finite = np.isfinite(ref)
    assert finite.sum() >= 3
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-10)
    np.testing.assert_array_equal(np.isfinite(got), finite)


@pytest.fixture(scope='module')
def flagship_eclipse(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('flagship_batched_ecl'))
    model, obs, ret, forward, p0 = make_flagship(
        workdir, rt_path='eclipse')
    return model, obs, ret, forward, np.asarray(p0)


def test_batched_eclipse_matches_vmap(flagship_eclipse):
    """Eclipse (plane-parallel emission + Fp/Fs) runs the batched hot
    path -- not the vmap fallback -- and matches it, including the
    deck blackbody surface, retrieved R_planet, and rejection."""
    model, obs, ret, forward, p0 = flagship_eclipse
    forward_b = build_forward_batched(model, obs, ret)
    assert not forward_b.is_fallback

    pb = _params(p0)
    ref = jax.jit(jax.vmap(
        lambda p: {k: forward(p)[k]
                   for k in ('spectrum', 'bandflux', 'good')},
    ))(pb)
    got = jax.jit(forward_b)(pb)

    np.testing.assert_array_equal(
        np.asarray(got['good']), np.asarray(ref['good']))
    assert not bool(np.asarray(ref['good'])[-1])
    np.testing.assert_allclose(
        np.asarray(got['spectrum']), np.asarray(ref['spectrum']),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(got['bandflux'])[:-1],
        np.asarray(ref['bandflux'])[:-1], rtol=1e-10,
    )
    assert np.all(np.isinf(np.asarray(got['bandflux'])[-1]))


def test_batched_eclipse_log_posterior(flagship_eclipse):
    model, obs, ret, forward, p0 = flagship_eclipse
    if getattr(obs, 'data', None) is None:
        band = np.asarray(forward(jnp.asarray(p0))['bandflux'])
        obs.data = band * (1 + 1e-4)
        obs.uncert = np.abs(band) * 1e-3 + 1e-12
    log_post = build_log_posterior(model, obs, ret)
    log_post_b = build_log_posterior_batched(model, obs, ret)

    # Clip into the prior box (log_p_cl starts AT its upper bound, so
    # raw jitter throws most chains out of bounds); keep the last
    # chain's temperature blow-up as the rejection case:
    pb = np.array(_params(p0, seed=2))
    pb[:-1] = np.clip(
        pb[:-1], np.asarray(ret.pmin), np.asarray(ret.pmax))
    pb = jnp.asarray(pb)
    ref = np.asarray(jax.jit(jax.vmap(log_post))(pb))
    got = np.asarray(jax.jit(log_post_b)(pb))
    finite = np.isfinite(ref)
    assert finite.sum() >= 3
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-10)
    np.testing.assert_array_equal(np.isfinite(got), finite)


def test_batched_hires_matches_vmap(tmp_path):
    """High-res channel on the batched hot path: grouped convolution +
    RV-shifted (or fixed-grid) resampling == the per-chain forward."""
    from pyratbay_tpu.io import io as pio
    from pyratbay_tpu.observation import Observation
    from pyratbay_tpu.retrieval import RetrievalParams

    workdir = str(tmp_path / 'flag_hires')
    model, obs0, ret0, fwd0, p0 = make_flagship(
        workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=2.0,
    )
    wl_hires = np.linspace(1.15, 1.25, 40)
    hires_file = workdir + '/hires_obs.dat'
    pio.write_observations(
        hires_file,
        np.full(40, 0.0066), np.full(40, 1e-5),
        [f'{wl:.6f} 0.0001 HIRES' for wl in wl_hires],
    )
    cfg = model.cfg
    cfg.obsfile_hires = hires_file
    cfg.inst_resolution = 20000.0
    base_params = cfg.retrieval_params

    for with_rv in (True, False):
        cfg.retrieval_params = base_params + (
            '\n    rv_shift   10.0  -100.0  100.0  5.0'
            if with_rv else ''
        )
        obs = Observation(cfg, model.wn)
        obs.data = np.full(obs.nbands, 0.0066)
        obs.uncert = np.full(obs.nbands, 2e-5)
        ret = RetrievalParams(model, obs)
        assert (ret.irv is not None) == with_rv

        from pyratbay_tpu.retrieval import build_forward
        forward = build_forward(model, obs, ret)
        forward_b = build_forward_batched(model, obs, ret)
        assert not forward_b.is_fallback

        pars = np.tile(np.asarray(ret.params), (4, 1))
        if with_rv:
            pars[:, ret.irv] = [10.0, -50.0, 0.0, 75.0]
        pars[1, 2] += 0.3
        pb = jnp.asarray(pars)
        ref = jax.jit(jax.vmap(
            lambda p: forward(p)['bandflux_hires']))(pb)
        got = jax.jit(forward_b)(pb)['bandflux_hires']
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-8,
        )

        log_post_b = build_log_posterior_batched(model, obs, ret)
        lp_ref = np.asarray(jax.jit(jax.vmap(
            build_log_posterior(model, obs, ret)))(pb))
        lp_got = np.asarray(jax.jit(log_post_b)(pb))
        np.testing.assert_allclose(lp_got, lp_ref, rtol=1e-8)


@pytest.mark.parametrize('geometry', ['transit', 'eclipse'])
def test_batched_fused_assembly_interpret(geometry, tmp_path, monkeypatch):
    """The builder's kernel operands (line-sample part, rank-1
    Rayleigh/haze pairs, CIA weights, deck) through the Triton RT
    kernel in the Pallas interpreter == vmap(forward).  The flagship
    depth (51 layers) exercises the 51 -> 64 layer padding, and its
    wave grid leaves a partial last tile.  Eclipse runs the dense XLA
    composition of the same operands."""
    monkeypatch.setattr(
        batched, 'transit_spectrum_ensemble', functools.partial(
            batched.transit_spectrum_ensemble, interpret=True),
    )
    workdir = str(tmp_path / f'fused_{geometry}')
    model, obs, ret, forward, p0 = make_flagship(
        workdir, nlayers=51, wl_low=1.1, wl_high=1.3, wnstep=5.0,
        rt_path=geometry,
    )
    assert model.nwave % 128
    forward_b = build_forward_batched(model, obs, ret)
    assert not forward_b.is_fallback
    pb = _params(p0, n=4)
    got = jax.jit(forward_b)(pb)
    ref = jax.jit(jax.vmap(
        lambda p: {k: forward(p)[k] for k in ('spectrum', 'good')},
    ))(pb)
    np.testing.assert_array_equal(
        np.asarray(got['good']), np.asarray(ref['good']))
    fin = np.asarray(ref['good'])
    np.testing.assert_allclose(
        np.asarray(got['spectrum'])[fin], np.asarray(ref['spectrum'])[fin],
        rtol=1e-8,
    )
