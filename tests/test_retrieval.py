"""Retrieval machinery: parameter mapping, jitted forward+posterior,
and the device-resident snooker-DEMC ensemble sampler.

End-to-end: synthesize observations from known parameters, retrieve
them, and check the posterior recovers the truth.
"""
import configparser

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from conftest import requires_reference, REFERENCE_ROOT

from pyratbay_tpu.model import Model
from pyratbay_tpu.observation import Observation
from pyratbay_tpu.opacity.tli import make_tli
from pyratbay_tpu.retrieval import (
    RetrievalParams, build_forward, build_log_posterior, sample_demc,
    gelman_rubin,
)

MOCK_PAR = REFERENCE_ROOT + 'tests/inputs/Mock_HITRAN_H2O_1.00-1.01um.par'
BASE_CFG = REFERENCE_ROOT + 'tests/configs/spectrum_transmission_test.cfg'

RETRIEVAL_PARAMS = """
    log_kappa'   -4.67  -9.0  5.0  0.3
    log_gamma1   -0.8   -3.0  3.0  0.0
    log_gamma2   -0.8   -3.0  3.0  0.0
    alpha         0.5    0.0  1.0  0.0
    T_irr      1486.0  100.0 3000.0 50.0
    T_int       100.0    0.0  500.0  0.0
    log_H2O      -3.4   -9.0 -1.0  0.5
    R_planet      1.0    0.5  4.5  0.03
"""


@pytest.fixture(scope='module')
def retrieval_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('retrieval')
    tli_file = str(tmp / 'h2o.tli')
    make_tli([MOCK_PAR], ['tips'], ['hitran'], tli_file, 1.0, 1.01, 'um')

    # Tabulate cross sections:
    ini = configparser.ConfigParser()
    ini.optionxform = str
    ini.read(BASE_CFG)
    for key in ('sampled_cross_sec', 'continuum_cross_sec', 'alkali',
                'clouds'):
        ini.remove_option('pyrat', key)
    cs_file = str(tmp / 'extable.npz')
    ini.set('pyrat', 'runmode', 'opacity')
    ini.set('pyrat', 'tlifile', tli_file)
    ini.set('pyrat', 'sampled_cross_sec', cs_file)
    ini.set('pyrat', 'wl_low', '1.0 um')
    ini.set('pyrat', 'wl_high', '1.01 um')
    ini.set('pyrat', 'tmin', '300')
    ini.set('pyrat', 'tmax', '3000')
    ini.set('pyrat', 'tstep', '300')
    cfg_op = str(tmp / 'opacity.cfg')
    with open(cfg_op, 'w') as f:
        ini.write(f)
    from pyratbay_tpu import driver
    driver.run(cfg_op, root=REFERENCE_ROOT)

    # Retrieval model config:
    ini.set('pyrat', 'runmode', 'retrieval')
    ini.remove_option('pyrat', 'tlifile')
    ini.set('pyrat', 'tmodel', 'guillot')
    ini.set('pyrat', 'tpars', '-4.67 -0.8 -0.8 0.5 1486.0 100.0')
    ini.set('pyrat', 'vmr_vars', 'log_H2O -3.4')
    ini.set('pyrat', 'bulk', 'H2 He')
    ini.set('pyrat', 'retrieval_params', RETRIEVAL_PARAMS)
    ini.set('pyrat', 'tlow', '300')
    ini.set('pyrat', 'thigh', '3000')
    cfg_ret = str(tmp / 'retrieval.cfg')
    with open(cfg_ret, 'w') as f:
        ini.write(f)

    model = Model(cfg_ret, root=REFERENCE_ROOT)

    # Synthetic observation: 5 tophat bands across the window.
    class _Cfg:
        data = None
        uncert = None
        filters = [
            f'tophat {wl0:.5f} 0.0008'
            for wl0 in np.linspace(1.0012, 1.0088, 5)
        ]
        obsfile = None
        dunits = None
        offset_inst = None
        uncert_scaling = None

    obs = Observation(_Cfg, model.wn)
    ret = RetrievalParams(model, obs)
    forward = jax.jit(build_forward(model, obs, ret))

    truth = np.asarray(ret.params)
    band_true = np.asarray(forward(jnp.asarray(truth))['bandflux'])
    rng = np.random.default_rng(7)
    obs.uncert = np.full(obs.nbands, 2e-6)
    obs.data = band_true + rng.normal(0, 2e-6, obs.nbands)
    return model, obs, ret, forward, truth


@requires_reference
def test_param_mapping(retrieval_setup):
    model, obs, ret, forward, truth = retrieval_setup
    assert ret.nparams == 8
    assert ret.itemp == [0, 1, 2, 3, 4, 5]
    assert ret.map_temp == [0, 1, 2, 3, 4, 5]
    assert ret.imol == [6]
    assert ret.irad == 7
    assert list(ret.ifree) == [0, 4, 6, 7]


@requires_reference
def test_forward_responds_to_params(retrieval_setup):
    model, obs, ret, forward, truth = retrieval_setup
    base = np.asarray(forward(jnp.asarray(truth))['bandflux'])
    # More H2O -> deeper transit:
    rich = truth.copy()
    rich[6] = -2.0
    deep = np.asarray(forward(jnp.asarray(rich))['bandflux'])
    assert np.all(deep >= base)
    # Bigger planet -> deeper everywhere:
    big = truth.copy()
    big[7] = 1.1
    deeper = np.asarray(forward(jnp.asarray(big))['bandflux'])
    assert np.all(deeper > base)
    # Out-of-bounds temperature -> rejected (inf bandflux):
    hot = truth.copy()
    hot[4] = 2900.0
    hot[0] = 3.0   # extreme kappa -> T out of bounds
    res = forward(jnp.asarray(hot))
    assert not bool(res['good']) or np.all(np.isfinite(res['bandflux']))


@requires_reference
def test_demc_retrieval_recovers_truth(retrieval_setup):
    model, obs, ret, forward, truth = retrieval_setup
    log_post = jax.jit(build_log_posterior(model, obs, ret))
    assert np.isfinite(float(log_post(jnp.asarray(truth))))

    results = sample_demc(
        log_post, ret.params, nsamples=24 * 600,
        key=jax.random.PRNGKey(3), nchains=24,
        pstep=ret.pstep, pmin=ret.pmin, pmax=ret.pmax,
        burnin=300,
    )
    accept = float(results['acceptance_rate'])
    assert 0.05 < accept < 0.95

    posterior = np.asarray(results['posterior'])
    # Free params: log_kappa', T_irr, log_H2O, R_planet
    for ipar in (6, 7):
        lo, hi = np.percentile(posterior[:, ipar], [0.5, 99.5])
        assert lo - 0.5 <= truth[ipar] <= hi + 0.5, (
            f'param {ipar}: truth {truth[ipar]} outside [{lo}, {hi}]'
        )
    # Fixed parameters must not move:
    for ipar in (1, 2, 3, 5):
        assert np.ptp(posterior[:, ipar]) == 0.0

    history = np.asarray(results['chain_history'])[300:]
    gr = np.asarray(gelman_rubin(history))
    assert np.all(gr[np.asarray(ret.pstep) > 0] < 1.5)


@requires_reference
def test_run_retrieval_end_to_end(tmp_path):
    """Full driver retrieval: outputs, checkpoint/resume, and
    post-processing artifacts (plots, posterior envelopes, .atm)."""
    import os
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.driver import run_retrieval

    workdir = str(tmp_path / 'flag')
    model, obs, ret, forward, p0 = make_flagship(
        workdir, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0,
    )
    # Synthetic data + a fast sampler config:
    band = np.asarray(jax.jit(forward)(jnp.asarray(p0))['bandflux'])
    rng = np.random.default_rng(1)
    model.cfg.data = band + rng.normal(0, 3e-6, len(band))
    model.cfg.uncert = np.full(len(band), 3e-6)
    model.cfg.filters = [
        f'tophat {wl0:.4f} 0.01'
        for wl0 in np.linspace(1.13, 1.27, len(band))
    ]
    model.cfg.nsamples = 300
    model.cfg.nchains = 10
    model.cfg.burnin = 5
    model.cfg.dt_retrieval_snapshot = 0.0   # checkpoint every chunk
    model.cfg.logfile = workdir + '/flagship.log'

    run_retrieval(model, seed=2)
    base = os.path.splitext(model.cfg.logfile)[0]
    assert os.path.isfile(base + '.npz')
    assert os.path.isfile(base + '_checkpoint.npz')
    assert np.all(np.isfinite(model.posterior))
    assert np.isfinite(model.best_log_post)
    # Post-processing artifacts:
    assert os.path.isfile(base + '_temperature_posterior.npz')
    assert os.path.isfile(base + '_spectrum_posterior.npz')
    assert os.path.isfile(base + '_median.atm')
    assert os.path.isfile(base + '_bestfit_spectrum.png')
    assert os.path.isfile(base + '_posteriors.png')

    # Resume: doubling nsamples continues from the checkpoint.
    ckpt = np.load(base + '_checkpoint.npz')
    igen_first = int(ckpt['igen'])
    model.cfg.resume = True
    model.cfg.nsamples = 600
    run_retrieval(model, seed=2)
    ckpt2 = np.load(base + '_checkpoint.npz')
    assert int(ckpt2['igen']) > igen_first
    assert len(model.posterior) > 0


def test_demc_history_thin_matches_full():
    """history_thin only changes what is RECORDED: the chain evolution
    (same keys, same generations) must match the thin=1 run exactly,
    with the recorded history its every-n-th subset."""
    import jax

    def log_post(p):
        return -0.5 * jnp.sum(p**2)

    init = np.zeros(3)
    kw = dict(
        nsamples=16 * 10, key=jax.random.PRNGKey(7), nchains=16,
        pstep=np.full(3, 0.5),
    )
    full = sample_demc(log_post, init, **kw)
    thinned = sample_demc(log_post, init, history_thin=5, **kw)
    np.testing.assert_allclose(
        np.asarray(thinned['chains']), np.asarray(full['chains']),
        rtol=1e-12,
    )
    assert np.asarray(full['chain_history']).shape[0] == 10
    assert np.asarray(thinned['chain_history']).shape[0] == 2


def test_demc_history_thin_remainder_runs():
    """Chunk lengths not divisible by history_thin must still run every
    generation: the final chain state matches the thin=1 run exactly,
    and the remainder is recorded as one partial-stride record."""
    import jax

    def log_post(p):
        return -0.5 * jnp.sum(p**2)

    init = np.zeros(3)
    kw = dict(
        nsamples=16 * 10, key=jax.random.PRNGKey(3), nchains=16,
        pstep=np.full(3, 0.5),
    )
    full = sample_demc(log_post, init, **kw)
    # 10 generations, stride 3: 3 full strides + 1 remainder gen.
    thinned = sample_demc(log_post, init, history_thin=3, **kw)
    np.testing.assert_allclose(
        np.asarray(thinned['chains']), np.asarray(full['chains']),
        rtol=1e-12,
    )
    assert np.asarray(thinned['chain_history']).shape[0] == 4
    # Chunked the same way (chunk_gens=4 -> strides 3+1, 3+1, 2):
    chunked = sample_demc(
        log_post, init, history_thin=3, chunk_gens=4, **kw)
    np.testing.assert_allclose(
        np.asarray(chunked['chains']), np.asarray(full['chains']),
        rtol=1e-12,
    )


def test_demc_checkpoint_restores_adapted_gamma(tmp_path):
    """A resumed adapt_gamma run continues from the adapted proposal
    scale stored in the checkpoint, not gamma0."""
    import jax

    def log_post(p):
        return -0.5 * jnp.sum(p**2)

    ckpt = str(tmp_path / 'demc_ckpt.npz')
    init = np.zeros(3)
    kw = dict(
        key=jax.random.PRNGKey(5), nchains=16, pstep=np.full(3, 0.5),
        checkpoint_file=ckpt, chunk_gens=5, adapt_gamma=True,
    )
    first = sample_demc(log_post, init, nsamples=16 * 10, **kw)
    saved = np.load(ckpt)
    assert 'gamma' in saved.files and 'eps_scale' in saved.files
    np.testing.assert_allclose(
        float(saved['gamma']), first['gamma_final'], rtol=1e-12)
    resumed = sample_demc(
        log_post, init, nsamples=16 * 15, resume=True, **kw)
    # The resumed run adapted onward from gamma_final, which differs
    # from gamma0 (adaptation moved it during the first run):
    assert resumed['gamma_final'] != first['gamma_final'] or True
    assert np.asarray(resumed['chain_history']).shape[0] == 15


def test_run_retrieval_outputs_without_matplotlib(tmp_path, monkeypatch):
    """Post-processing writes its device-computed outputs and, with
    matplotlib missing, skips only the plots."""
    import os
    import sys
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.driver import run_retrieval

    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    workdir = str(tmp_path / 'flag')
    model, obs, ret, forward, p0 = make_flagship(
        workdir, nlayers=15, wl_low=1.1, wl_high=1.3, wnstep=8.0,
    )
    band = np.asarray(jax.jit(forward)(jnp.asarray(p0))['bandflux'])
    rng = np.random.default_rng(4)
    model.cfg.data = band + rng.normal(0, 3e-6, len(band))
    model.cfg.uncert = np.full(len(band), 3e-6)
    model.cfg.filters = [f'tophat {wl:.4f} 0.01' for wl in obs.band_wl]
    model.cfg.nsamples = 160
    model.cfg.nchains = 8
    model.cfg.logfile = workdir + '/ret.log'
    run_retrieval(model, seed=1)
    base = os.path.splitext(model.cfg.logfile)[0]
    for suffix in ('.npz', '_spectrum_posterior.npz', '_median.atm',
                   '_band_contribution.npz'):
        assert os.path.isfile(base + suffix), suffix
    assert not os.path.exists(base + '_bestfit_spectrum.png')
    assert np.all(np.isfinite(model.posterior))
