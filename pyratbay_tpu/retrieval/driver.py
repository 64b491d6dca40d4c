"""Retrieval run-mode driver: wire config -> observation -> parameter
space -> jitted posterior -> ensemble sampler -> outputs.
"""
import os

import numpy as np
import jax

from ..observation import Observation
from .params import RetrievalParams
from .batched import build_log_posterior_batched
from .forward import build_forward, build_log_posterior
from .samplers import sample_demc, gelman_rubin

__all__ = ['run_retrieval']


def _run_nested(model, obs, ret, log_post, seed):
    """Nested-sampling run (the MultiNest-interface slot): batched
    MCMC nested sampling with a uniform
    unit-cube prior over [pmin, pmax] (fixed params stay fixed)."""
    import jax.numpy as jnp
    from .nested import sample_nested

    free = np.asarray(ret.ifree)
    base = jnp.asarray(ret.params)
    lo = jnp.asarray(ret.pmin[free])
    span = jnp.asarray(ret.pmax[free] - ret.pmin[free])

    def prior_transform(u):
        return base.at[jnp.asarray(free)].set(lo + span * u)

    results = sample_nested(
        lambda params: log_post(params),
        prior_transform,
        ndim=len(free),
        nlive=model.cfg.nlive or 400,
        key=jax.random.PRNGKey(seed),
    )
    # Match the DEMC result contract:
    posterior = results['posterior']
    log_posts = results['log_like']
    ibest = int(np.argmax(log_posts))
    results['bestp'] = results['samples'][ibest]
    results['best_log_post'] = float(log_posts[ibest])
    results['acceptance_rate'] = results['efficiency']
    results['chain_history'] = posterior[None, :, :]
    return results


def run_retrieval(model, seed=0):
    """Run the MCMC retrieval configured in model.cfg.

    Stores results on the model (.posterior, .bestp, .spec_best) and
    writes a <retrieval_file>.npz output.
    """
    cfg = model.cfg
    obs = Observation(
        cfg, model.wn,
        root=os.path.dirname(cfg.config_file) + '/',
    )
    has_lowres = obs.data is not None and obs.nbands > 0
    has_hires = getattr(obs, 'data_hires', None) is not None
    if not has_lowres and not has_hires:
        raise ValueError(
            'Undefined observed data/filters, required for retrieval'
        )
    ret = RetrievalParams(model, obs)
    log_post = jax.jit(build_log_posterior(model, obs, ret))
    # Ensemble hot path for the DEMC generations (falls back to
    # vmap(log_post) semantics transparently; retrieval/batched.py):
    log_post_b = jax.jit(build_log_posterior_batched(model, obs, ret))

    nchains = ret.nchains or 21
    nsamples = ret.nsamples or 1000
    # burnin counts per-chain samples (reference parser.py:1085-1086,
    # "Number of burn-in samples per chain"); one DEMC generation
    # advances every chain by one sample, so generations == burnin:
    burnin_gens = int(ret.burnin or 0)
    log = model.log
    if log.logname is None and cfg.logfile is not None:
        # Direct API calls (not via driver.run): open the file log now.
        from ..logger import Log
        try:
            log = Log(
                logname=cfg.logfile,
                verb=log.verb, append=bool(cfg.resume),
            )
            model.log = log
        except OSError:
            pass

    # Periodic chain checkpoints + resume (the reference's
    # dt_retrieval_snapshot / resume, tools/retrieval_tools.py:81-170):
    checkpoint_file = None
    if cfg.logfile is not None and (
            cfg.dt_retrieval_snapshot is not None or cfg.resume):
        checkpoint_file = (
            os.path.splitext(cfg.logfile)[0] + '_checkpoint.npz'
        )

    log.head(
        f'Retrieval: {len(ret.ifree)} free parameters, {nchains} '
        f'chains, {nsamples} samples ({ret.sampler or "snooker"} '
        'sampler)'
    )
    if ret.sampler == 'multinest':
        # Be explicit about what actually runs: not pymultinest, but
        # this package's device-batched nested sampler:
        log.msg(
            "sampler = multinest runs the native batched "
            "nested sampler (retrieval/nested.py): MultiNest-style "
            "evidence + posterior from a live-point ensemble on "
            "device, with friends-of-friends mode separation "
            "(per-mode evidences in results['mode_logz']) and a "
            "Monte-Carlo (volume-resampling) logz_err."
        )
        results = _run_nested(model, obs, ret, log_post, seed)
    else:
        results = sample_demc(
            log_post,
            ret.params,
            nsamples=nsamples,
            key=jax.random.PRNGKey(seed),
            nchains=nchains,
            pstep=ret.pstep,
            pmin=ret.pmin,
            pmax=ret.pmax,
            burnin=burnin_gens,
            checkpoint_file=checkpoint_file,
            checkpoint_dt=cfg.dt_retrieval_snapshot,
            resume=bool(cfg.resume),
            log=log,
            log_post_batched=log_post_b,
        )

    model.ret = ret
    model.obs = obs
    if 'logz' in results:
        model.logz = results['logz']
        model.logz_err = results['logz_err']
    model.posterior = np.asarray(results['posterior'])
    model.bestp = np.asarray(results['bestp'])
    model.best_log_post = float(results['best_log_post'])
    model.acceptance_rate = float(results['acceptance_rate'])

    # Best-fit spectrum:
    forward = jax.jit(build_forward(model, obs, ret))
    best = forward(results['bestp'])
    model.spec_best = np.asarray(best['spectrum'])
    model.bandflux_best = np.asarray(best['bandflux'])

    # Gelman-Rubin diagnostic on the post-burn-in generations:
    history = np.asarray(results['chain_history'])[burnin_gens:]
    if len(history) > 2:
        model.grfactor = np.asarray(gelman_rubin(history))

    outfile = None
    if cfg.logfile is not None:
        outfile = os.path.splitext(cfg.logfile)[0] + '.npz'
        extra = {}
        if 'logz' in results:
            extra['logz'] = results['logz']
            extra['logz_err'] = results['logz_err']
        np.savez(
            outfile,
            **extra,
            posterior=model.posterior,
            bestp=model.bestp,
            pnames=np.asarray(ret.pnames),
            best_log_post=model.best_log_post,
            acceptance_rate=model.acceptance_rate,
            spec_best=model.spec_best,
            bandflux_best=model.bandflux_best,
            data=obs.data,
            uncert=obs.uncert,
        )
        log.msg(f'Posterior saved to {outfile}')

    log.msg(
        f'Acceptance rate: {model.acceptance_rate:.3f}; best '
        f'log-posterior: {model.best_log_post:.2f}'
    )
    if hasattr(model, 'grfactor'):
        log.msg(
            'Gelman-Rubin: '
            + ' '.join(f'{g:.4f}' for g in np.atleast_1d(model.grfactor))
        )
    post_process(model, obs, ret, forward, results)
    return results


def posterior_post_processing(cfg_file, suffix='', root=None):
    """Re-run the retrieval post-processing from a saved posterior
    (the `pbay-tpu --post cfg` entry; reference
    tools/retrieval_tools.py:384).
    """
    from ..model import Model
    from ..observation import Observation

    model = Model(cfg_file, root=root)
    cfg = model.cfg
    obs = Observation(
        cfg, model.wn, root=os.path.dirname(cfg.config_file) + '/',
    )
    ret = RetrievalParams(model, obs)
    forward = jax.jit(build_forward(model, obs, ret))

    base = os.path.splitext(cfg.logfile)[0]
    saved = np.load(base + '.npz')
    model.posterior = saved['posterior']
    model.bestp = saved['bestp']
    model.best_log_post = float(saved['best_log_post'])
    model.spec_best = saved['spec_best']
    model.bandflux_best = saved['bandflux_best']
    results = {'posterior': model.posterior}
    if suffix:
        model.cfg.logfile = base + suffix + os.path.splitext(
            cfg.logfile)[1]
    post_process(model, obs, ret, forward, results)
    return model


def post_process(model, obs, ret, forward, results):
    """Retrieval outputs: temperature-profile posterior envelopes,
    spectrum credible envelopes, posterior median atmosphere dump, and
    summary plots (reference pyrat/pyrat_obj.py:478-556).
    """
    from .posterior import (
        marginal_statistics, spectrum_posterior, temperature_posterior,
    )
    from ..io import io as pio

    cfg = model.cfg
    log = model.log
    if cfg.logfile is None:
        return
    base = os.path.splitext(cfg.logfile)[0]
    posterior = model.posterior
    ifree = np.asarray(ret.ifree)

    # Marginal statistics per free parameter:
    stats = marginal_statistics(posterior[:, ifree])
    for j, i in enumerate(ifree):
        log.msg(
            f'  {ret.pnames[i]:16s} = {stats[1, j]:.4e} '
            f'+{stats[2, j] - stats[1, j]:.3e} '
            f'-{stats[1, j] - stats[0, j]:.3e}'
        )

    # Temperature-profile posterior envelope:
    tpost = None
    if ret.itemp and model.temp_model is not None:
        tpars_draws = posterior[:, np.asarray(ret.itemp)]
        base_tpars = np.asarray(
            model.tpars if model.tpars is not None
            else np.zeros(len(ret.map_temp)),
        )
        slots = np.asarray(ret.map_temp)

        def tmodel_fn(draw):
            import jax.numpy as jnp
            pars = jnp.asarray(base_tpars).at[slots].set(draw)
            return model.temp_model(pars)

        # Thin for tractability:
        draws = tpars_draws[:: max(1, len(tpars_draws) // 2000)]
        tpost = temperature_posterior(draws, tmodel_fn)
        np.savez(
            base + '_temperature_posterior.npz',
            press=model.press, median=tpost[0],
            low1=tpost[1], high1=tpost[2],
            low2=tpost[3], high2=tpost[4],
        )

    # Spectrum credible envelope:
    spost = spectrum_posterior(
        posterior[:: max(1, len(posterior) // 256)],
        lambda p: forward(p)['spectrum'],
        max_draws=128,
    )
    np.savez(
        base + '_spectrum_posterior.npz',
        wn=np.asarray(model.wn), median=spost[0],
        low1=spost[1], high1=spost[2], low2=spost[3],
        high2=spost[4], spec_best=model.spec_best,
    )

    # Posterior-median atmosphere dump (.atm):
    med = np.median(np.asarray(results['posterior']), axis=0)
    temp = np.asarray(forward(med)['temperature'])
    median_vmr = np.asarray(model.eval_vmr(temp=temp))
    pio.write_atm(
        base + '_median.atm', model.press, temp, model.species,
        median_vmr, punits='bar',
    )

    # Band contribution functions (emission) / transmittances (transit)
    # at the best fit (reference pyrat_obj.py:538-548, 671-696):
    band_cf = None
    if obs is not None and obs.nbands and model.bestp is not None:
        best_out = forward(model.bestp)
        band_cf = model.band_contribution(obs, result=best_out)
        np.savez(
            base + '_band_contribution.npz',
            press=np.asarray(model.press), band_cf=band_cf,
            band_wl=np.asarray(obs.band_wl),
        )
        log.msg(
            f'Band contribution functions written to '
            f'{base}_band_contribution.npz'
        )

    # Plots (headless-safe); matplotlib is optional:
    try:
        import matplotlib
    except ImportError:
        log.warning('matplotlib is not installed: no plots written')
        return
    matplotlib.use('Agg')
    from .. import plots
    from .. import constants as pc
    wl = 1.0 / (np.asarray(model.wn) * pc.um)
    band_wl = obs.band_wl
    rt_key = (
        'transit' if model.rt_path in pc.TRANSMISSION_RT else
        'eclipse' if model.rt_path in pc.ECLIPSE_RT else 'emission'
    )
    plots.spectrum(
        model.spec_best, wl,
        data=obs.data, uncert=obs.uncert, band_wl=band_wl,
        bandflux=model.bandflux_best,
        rt_path=rt_key,
        filename=base + '_bestfit_spectrum.png',
    )
    plots.posteriors(
        posterior[:, ifree],
        pnames=[ret.pnames[i] for i in ifree],
        bestp=model.bestp[ifree],
        filename=base + '_posteriors.png',
    )
    if tpost is not None:
        plots.temperature(
            model.press, profiles=[tpost[0]],
            bounds=(tpost[1], tpost[2], tpost[3], tpost[4]),
            filename=base + '_temperature.png',
        )
    if band_cf is not None:
        plots.contribution(
            band_cf, np.asarray(obs.band_wl),
            np.asarray(model.press),
            filename=base + '_band_contribution.png',
        )
    plots.abundance(
        median_vmr, np.asarray(model.press), model.species,
        filename=base + '_abundance.png',
    )
    log.msg(f'Plots written to {base}_*.png')
