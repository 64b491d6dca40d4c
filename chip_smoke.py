"""Bring-up check of the retrieval path on one NVIDIA GPU.

    python chip_smoke.py            # every single-card phase
    python chip_smoke.py --multi    # only the 4-card sharded phase

One JAX process drives the card.  The CPU references run in the same
process on jax.devices('cpu')[0].  Each phase prints one line: its wall
time, the device's peak bytes in use so far, and its comparison error
against the tolerance.  Any failure raises: the script then exits
nonzero and prints no result.  The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Phases (flagship: HD 209458 b-like transmission, 51 layers x 3,209
wavenumbers, pyratbay_tpu.benchmark.make_flagship):
  spectrum-transit / spectrum-eclipse: driver.run(cfg), the function
      `pbay-tpu -c` calls, against the same run on the CPU device;
  batched-transit: build_forward_batched at 1,024 chains (the Triton
      RT kernel) against jax.vmap of the plain forward on the card and
      on the CPU device (16 chains), with both timed;
  batched-eclipse: 256 chains against the CPU device (16 chains);
  retrieval: run_retrieval with 1,024 DEMC chains on synthetic data;
  lbl-tabulate: DirectLBL.tabulate over 50k synthetic lines against
      the CPU device;
  multi (--multi only): the (chains 2 x wave 2) sharded DEMC step
      and nested sampling on four cards.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

from pyratbay_tpu.compile_cache import enable_compile_cache

FULL = dict(chains=1024, eclipse_chains=256, ref_chains=16,
            generations=300, lbl_lines=50_000, flagship={})


def rel_err(got, ref):
    """Max over rows of max|got - ref| / max|ref| (per row)."""
    got = np.atleast_2d(np.asarray(got, np.float64))
    ref = np.atleast_2d(np.asarray(ref, np.float64))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.isfinite(got)), 'non-finite values'
    scale = np.max(np.abs(ref), axis=1)
    return float(np.max(np.max(np.abs(got - ref), axis=1) / scale))


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get('peak_bytes_in_use')


def report(name, start, err=None, tol=None, **extra):
    line = (f'phase {name}: wall {time.perf_counter() - start:.2f} s, '
            f'peak {peak_bytes()} B')
    if err is not None:
        line += f', err {err:.3e} (tol {tol:.0e})'
    for key, val in extra.items():
        line += f', {key} {val}'
    print(line, flush=True)
    if err is not None:
        assert err <= tol, f'{name}: error {err:.3e} > {tol:.0e}'


def timed(fn, args, repeats=10):
    """Median seconds of `repeats` calls that end in block_until_ready."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - start)
    return float(np.median(times))


def jitter(p0, n, seed):
    rng = np.random.default_rng(seed)
    return (np.tile(p0, (n, 1))
            + 0.01 * rng.standard_normal((n, len(p0)))).astype(np.float32)


def on_cpu(fn, *args):
    """fn(*args) with constants and computation on the CPU device."""
    cpu = jax.devices('cpu')[0]
    with jax.default_device(cpu):
        return fn(*jax.device_put(args, cpu))


def phase_spectrum(sizes, workdir, geometry):
    from pyratbay_tpu import driver
    from pyratbay_tpu.benchmark import make_flagship

    start = time.perf_counter()
    model = make_flagship(os.path.join(workdir, f'spec_{geometry}'),
                          rt_path=geometry, **sizes['flagship'])[0]
    cfg = model.cfg.config_file
    got = np.asarray(driver.run(cfg).spectrum)
    ref = np.asarray(on_cpu(lambda: driver.run(cfg).spectrum))
    report(f'spectrum-{geometry}', start, rel_err(got, ref), 1e-4)


def phase_batched_transit(sizes, workdir):
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.batched import build_forward_batched

    start = time.perf_counter()
    model, obs, ret, forward, p0 = make_flagship(
        os.path.join(workdir, 'batched_transit'), **sizes['flagship'])
    params = jnp.asarray(jitter(p0, sizes['chains'], seed=0))
    forward_b = build_forward_batched(model, obs, ret)
    kernel = jax.jit(lambda p: forward_b(p)['spectrum'])
    xla = jax.jit(lambda p: jax.vmap(forward)(p)['spectrum'])
    assert 'triton' in kernel.lower(params).as_text().lower(), \
        'the batched transit forward did not lower the Triton kernel'
    got = np.asarray(kernel(params))
    ref = np.asarray(xla(params))
    err_xla = rel_err(got, ref)
    nref = sizes['ref_chains']
    ref_cpu = on_cpu(lambda p: jax.jit(
        lambda q: jax.vmap(forward)(q)['spectrum'])(p), params[:nref])
    err_cpu = rel_err(got[:nref], ref_cpu)
    t_xla = timed(xla, (params,))
    t_kernel = timed(kernel, (params,))
    t_xla2 = timed(xla, (params,))
    t_kernel2 = timed(kernel, (params,))
    report('batched-transit', start, err_cpu, 1e-4,
           kernel_vs_xla_err=f'{err_xla:.3e} (tol 2e-05)',
           chains=sizes['chains'],
           kernel_s=f'{t_kernel:.6f},{t_kernel2:.6f}',
           xla_vmap_s=f'{t_xla:.6f},{t_xla2:.6f}')
    assert err_xla <= 2e-5, f'kernel vs XLA: {err_xla:.3e} > 2e-05'


def phase_batched_eclipse(sizes, workdir):
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.batched import build_forward_batched

    start = time.perf_counter()
    model, obs, ret, forward, p0 = make_flagship(
        os.path.join(workdir, 'batched_eclipse'), rt_path='eclipse',
        **sizes['flagship'])
    params = jnp.asarray(jitter(p0, sizes['eclipse_chains'], seed=1))
    forward_b = build_forward_batched(model, obs, ret)
    step = jax.jit(lambda p: forward_b(p)['spectrum'])
    got = np.asarray(step(params))
    nref = sizes['ref_chains']
    ref = on_cpu(lambda p: jax.jit(
        lambda q: jax.vmap(forward)(q)['spectrum'])(p), params[:nref])
    report('batched-eclipse', start, rel_err(got[:nref], ref), 1e-4,
           chains=sizes['eclipse_chains'],
           step_s=f'{timed(step, (params,)):.6f}')


def phase_retrieval(sizes, workdir):
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.driver import run_retrieval

    start = time.perf_counter()
    wdir = os.path.join(workdir, 'retrieval')
    model, obs, ret, forward, p0 = make_flagship(wdir, **sizes['flagship'])
    band = np.asarray(jax.jit(forward)(jnp.asarray(p0))['bandflux'])
    rng = np.random.default_rng(2)
    cfg = model.cfg
    cfg.data = band + rng.normal(0.0, 3e-5, band.shape)
    cfg.uncert = np.full(band.shape, 3e-5)
    cfg.filters = [f'tophat {wl:.4f} 0.01' for wl in obs.band_wl]
    cfg.nchains = sizes['chains']
    cfg.nsamples = sizes['chains'] * sizes['generations']
    cfg.burnin = sizes['generations'] // 3
    cfg.logfile = os.path.join(wdir, 'retrieval.log')
    run_retrieval(model, seed=3)
    assert np.all(np.isfinite(model.posterior)), 'non-finite posterior'
    assert model.acceptance_rate > 0.0, 'no proposal accepted'
    base = os.path.splitext(cfg.logfile)[0]
    for suffix in ('_spectrum_posterior.npz', '_band_contribution.npz',
                   '_median.atm'):
        assert os.path.isfile(base + suffix), f'missing {base + suffix}'
    report('retrieval', start, chains=sizes['chains'],
           generations=sizes['generations'],
           acceptance=f'{model.acceptance_rate:.3f}',
           best_log_post=f'{model.best_log_post:.2f}')


def phase_lbl(sizes):
    from pyratbay_tpu.benchmark import synthetic_lines
    from pyratbay_tpu.opacity.lbl_tpu import DirectLBL

    start = time.perf_counter()
    lines = synthetic_lines(nlines=sizes['lbl_lines'])
    temps = np.array([800.0, 2400.0])
    press = np.logspace(-4, 1, 4)
    vmr = np.tile([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7],
                  (len(press), 1))
    t0 = time.perf_counter()
    got = DirectLBL(lines).tabulate(temps, press, vmr, block=4)
    first_call = time.perf_counter() - t0
    ref = on_cpu(lambda: DirectLBL(lines).tabulate(temps, press, vmr,
                                                   block=4))
    err = rel_err(got.reshape(-1, got.shape[-1]),
                  ref.reshape(-1, ref.shape[-1]))
    report('lbl-tabulate', start, err, 2e-4, lines=sizes['lbl_lines'],
           cells=got.shape[0] * got.shape[1],
           compile_and_first_call_s=f'{first_call:.2f}')


def phase_multi(sizes, workdir):
    from jax import random
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.parallel.sharded import (
        build_flagship_sharded, make_mesh,
    )
    from pyratbay_tpu.retrieval.forward import build_log_posterior
    from pyratbay_tpu.retrieval.nested import sample_nested

    start = time.perf_counter()
    devices = jax.devices()[:4]
    assert len(devices) == 4, f'--multi needs 4 devices, found {len(devices)}'
    mesh = make_mesh(devices)
    assert dict(mesh.shape) == {'chains': 2, 'wave': 2}, mesh.shape
    model, obs, ret, log_post, step, chains, logp_sharding = (
        build_flagship_sharded(mesh, os.path.join(workdir, 'sharded'),
                               **sizes['flagship']))
    logp = jax.device_put(
        np.full(chains.shape[0], -1e10, np.float32), logp_sharding)
    chains, logp = step(chains, logp, random.PRNGKey(0))
    chains = np.asarray(chains)
    logp = np.asarray(logp)

    # The same chains on one device, unsharded tables, same data:
    single = make_flagship(os.path.join(workdir, 'single'),
                           **sizes['flagship'])
    s_model, s_obs, s_ret = single[:3]
    s_obs.data, s_obs.uncert = np.asarray(obs.data), np.asarray(obs.uncert)
    logp_single = np.asarray(jax.jit(jax.vmap(
        build_log_posterior(s_model, s_obs, s_ret)))(
            jax.device_put(chains, devices[0])))
    moved = logp > -1e9
    assert moved.any(), 'the sharded step accepted no chain'
    err = float(np.max(np.abs(logp[moved] - logp_single[moved])
                       / np.maximum(1.0, np.abs(logp_single[moved]))))
    report('multi-demc-step', start, err, 1e-4, mesh=dict(mesh.shape),
           chains=len(chains))

    start = time.perf_counter()
    pmin = np.asarray(ret.pmin)
    span = jnp.asarray(np.asarray(ret.pmax) - pmin)
    lo = jnp.asarray(pmin)
    res = sample_nested(
        log_post, lambda u: lo + span * u, len(pmin),
        nlive=64, max_iter=64, nsteps_walk=4, batch=8, mesh=mesh,
        key=random.PRNGKey(2),
    )
    assert np.isfinite(res['logz']), 'non-finite logz'
    assert np.all(np.isfinite(res['samples'])), 'non-finite samples'
    report('multi-nested', start, logz=f'{float(res["logz"]):.3f}')


def card_line():
    """Name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def run_phases(sizes, multi, workdir):
    if multi:
        phase_multi(sizes, workdir)
        return
    phase_spectrum(sizes, workdir, 'transit')
    phase_spectrum(sizes, workdir, 'eclipse')
    phase_batched_transit(sizes, workdir)
    phase_batched_eclipse(sizes, workdir)
    phase_retrieval(sizes, workdir)
    phase_lbl(sizes)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--multi', action='store_true',
                        help='run only the 4-card sharded phase')
    args = parser.parse_args(argv)

    device = jax.devices()[0]
    if device.platform != 'gpu':
        print(f'chip_smoke: no GPU (JAX found {device.platform})',
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    print(f'device_kind {device.device_kind}, count {len(jax.devices())},'
          f' compile cache {cache}', flush=True)
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as workdir:
        run_phases(FULL, args.multi, workdir)
    print(json.dumps({'ok': True, 'device': {
        'platform': device.platform, 'kind': device.device_kind,
        'count': len(jax.devices()),
    }}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
