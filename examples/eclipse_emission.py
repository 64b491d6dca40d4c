"""Cookbook: emission spectra and a mini eclipse retrieval.

Builds the same atmosphere in three geometries (transit, emission,
eclipse Fp/Fs), then runs a short eclipse retrieval on the batched
ensemble hot path (retrieval/batched.py).

    python examples/eclipse_emission.py
"""
import os

import jax
jax.config.update('jax_platforms', 'cpu')

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt
import numpy as np
import jax.numpy as jnp

from pyratbay_tpu.benchmark import make_flagship
from pyratbay_tpu.retrieval import sample_demc
from pyratbay_tpu.retrieval.batched import build_log_posterior_batched

FAST = os.environ.get('PBT_EXAMPLE_FAST') == '1'

# --- Spectra in three geometries ------------------------------------
fig, axes = plt.subplots(2, 1, figsize=(7, 6), sharex=True)
model_t, *_ = make_flagship('demo_transit', nlayers=31, wnstep=2.0)
model_t.run()
wl = 1e4 / np.asarray(model_t.wn)
axes[0].plot(wl, model_t.spectrum, lw=0.7, label='transit (Rp/Rs)^2')
axes[0].set_ylabel('transit depth')
axes[0].legend()

model_e, obs, ret, forward, p0 = make_flagship(
    'demo_eclipse', nlayers=31, wnstep=2.0, rt_path='eclipse',
)
model_e.run()
axes[1].plot(wl, model_e.spectrum, lw=0.7, color='C3',
             label='eclipse Fp/Fs')
axes[1].set_xlabel('wavelength (um)')
axes[1].set_ylabel('Fp/Fs')
axes[1].legend()
fig.savefig('eclipse_emission_spectra.png', dpi=100)
print('wrote eclipse_emission_spectra.png')

# --- Mini eclipse retrieval on the batched hot path ------------------
band = np.asarray(jax.jit(forward)(jnp.asarray(p0))['bandflux'])
rng = np.random.default_rng(7)
obs.data = band + rng.normal(0.0, 0.03 * np.abs(band))
obs.uncert = 0.03 * np.abs(band)

log_post_b = build_log_posterior_batched(model_e, obs, ret)
assert not getattr(log_post_b, 'is_fallback', False)

nchains = 16 if FAST else 64
nsamples = nchains * (20 if FAST else 400)
results = sample_demc(
    None, np.asarray(p0), nsamples=nsamples, nchains=nchains,
    pstep=ret.pstep, pmin=ret.pmin, pmax=ret.pmax,
    log_post_batched=jax.jit(log_post_b),
    key=jax.random.PRNGKey(0),
)
post = results['posterior']
print(f'eclipse retrieval: {post.shape[0]} samples, '
      f'acceptance {float(results["acceptance_rate"]):.2f}, '
      f'best logp {float(results["best_log_post"]):.1f}')
print('median parameters:', np.median(post, axis=0).round(3))
