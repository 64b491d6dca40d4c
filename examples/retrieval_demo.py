"""Cookbook: end-to-end transmission retrieval on synthetic data.

Builds the flagship HD 209458 b-like transmission model (no external
files), synthesizes noisy band fluxes at the true parameters, and runs
a short device-ensemble snooker-DEMC retrieval.  ~1 minute on CPU;
on a GPU the same code runs thousands of chains.

    python examples/retrieval_demo.py
"""
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import os

import numpy as np

from pyratbay_tpu.benchmark import make_flagship
from pyratbay_tpu.retrieval import build_log_posterior, sample_demc

model, obs, ret, forward, p0 = make_flagship()
print(f'model: {model.nlayers} layers x {model.nwave} wavenumbers, '
      f'{len(ret.pnames)} free parameters')
print('parameters:', list(ret.pnames))

# Synthetic observation: bandflux at truth + 30 ppm noise
truth = np.asarray(p0)
bandflux = np.asarray(forward(truth)['bandflux'])
rng = np.random.default_rng(42)
obs.data = bandflux + rng.normal(0.0, 3e-5, bandflux.shape)
obs.uncert = np.full_like(bandflux, 3e-5)

log_post = jax.jit(build_log_posterior(model, obs, ret))
print(f'log-posterior at truth: {float(log_post(truth)):.1f}')

out = sample_demc(
    log_post, truth,
    # PBT_EXAMPLE_FAST: CI smoke-run size (tests/test_examples.py):
    nsamples=(20_000 if os.environ.get('PBT_EXAMPLE_FAST') else 40_000),
    nchains=64,
    pstep=ret.pstep, pmin=ret.pmin, pmax=ret.pmax,
    burnin=(100 if os.environ.get('PBT_EXAMPLE_FAST') else 200),
)
post = np.asarray(out['posterior'])
print(f'posterior draws: {post.shape}, '
      f'acceptance {out["acceptance_rate"]:.2f}')
for i, name in enumerate(ret.pnames):
    med = np.median(post[:, i])
    lo, hi = np.percentile(post[:, i], [16, 84])
    flag = ' <-- truth outside 1sigma' if not lo <= truth[i] <= hi \
        else ''
    print(f'  {name:>12s}: {med:9.3f} +{hi - med:.3f} -{med - lo:.3f}'
          f'  (truth {truth[i]:.3f}){flag}')
