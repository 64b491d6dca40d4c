"""Benchmark driver: flagship forward-model throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Workload (BASELINE.json config 1): HD 209458 b-like transmission
retrieval forward -- line-sampled H2O + H2-H2 CIA + Na alkali +
deck/haze clouds + hydrostatic radii, 51 layers x 3209 wavenumbers,
float32, batched over a 512-chain ensemble (the retrieval hot loop).

Baseline: the reference's C forward path (interp_ec + alkali +
CIA interp + per-impact-parameter optdepth + transmission integral,
gcc -O3 -ffast-math, same shapes) timed on this host, scaled by the
host core count (the reference parallelizes chains over cores with
multiprocessing).

Timing methodology: every rate is N pipelined dispatches ended by
jax.block_until_ready on the last result, divided by N -- the
sustained device throughput.  The script fails when JAX finds no GPU.

Secondary metrics:
  * lbl_line_pairs_per_s -- DirectLBL (point, line)-pair rate over a
    50k-line synthetic list at the flagship grid (pairs counted over
    the full cutoff window, the same definition as round 1), with
    cells batched 8-per-program as in real tabulation;
  * lbl_grid_points_per_s -- wavenumber points sampled per second in
    the same workload;
  * tabulation_points_per_s -- DirectLBL.tabulate() (T, layer, wave)
    grid points per second (the runmode=opacity workload);
  * highres_spectra_per_s -- forward throughput at R = 25,000
    (~10,900 wavenumbers), batch 64.
"""
import json
import os
import sys
import time

import numpy as np


_T0 = time.perf_counter()


def _stage(msg):
    """Progress stamp on stderr (stdout carries only the JSON line)."""
    print(f'[bench +{time.perf_counter() - _T0:7.1f}s] {msg}',
          file=sys.stderr, flush=True)


def _rate(fn, n_iter):
    """Sustained seconds per call: pipelined dispatches, then one
    block_until_ready on the last result."""
    import jax
    jax.block_until_ready(fn())  # warm-up / compile
    start = time.perf_counter()
    out = None
    for _ in range(n_iter):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - start) / n_iter


def _rate_stats(fn, n_iter, repeats=3):
    """Repeat _rate and report (median_dt, spread_pct): every headline
    metric carries its own within-run spread.
    spread_pct = 100 * (max - min) / median over `repeats` repeats.
    """
    dts = sorted(_rate(fn, n_iter) for _ in range(repeats))
    med = dts[len(dts) // 2] if repeats % 2 else (
        0.5 * (dts[repeats // 2 - 1] + dts[repeats // 2]))
    spread = 100.0 * (dts[-1] - dts[0]) / med if med > 0 else 0.0
    return med, round(spread, 1)


def main():
    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import make_flagship, reference_c_baseline
    from pyratbay_tpu.compile_cache import enable_compile_cache

    device = jax.devices()[0]
    if device.platform != 'gpu':
        print(f'bench: no GPU (JAX found {device.platform})',
              file=sys.stderr)
        return 1
    enable_compile_cache()

    batch = int(os.environ.get('PBT_BENCH_BATCH', 512))
    n_iter = int(os.environ.get('PBT_BENCH_ITER', 25))

    _stage('flagship: build + compile')
    model, obs, ret, forward, p0 = make_flagship()
    nwave = model.nwave

    # Ensemble hot path (retrieval/batched.py): operand assembly + the
    # fused transit-RT kernel:
    from pyratbay_tpu.retrieval.batched import build_forward_batched
    forward_b = build_forward_batched(model, obs, ret)
    batched = jax.jit(lambda p: forward_b(p)['bandflux'])
    rng = np.random.default_rng(0)
    params = jnp.asarray((
        np.tile(p0, (batch, 1))
        + 0.01 * rng.standard_normal((batch, len(p0)))
    ).astype(np.float32))

    # Bytes and FLOPs straight from the compiled program:
    compiled = batched.lower(params).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    bytes_per_batch = float(cost.get('bytes accessed', 0.0))
    flops_per_batch = float(cost.get('flops', 0.0))

    sample = np.asarray(batched(params))
    if not np.all(np.isfinite(sample)):
        print(json.dumps({
            'metric': 'forward-model throughput',
            'value': 0.0,
            'unit': 'spectra/s',
            'vs_baseline': 0.0,
            'error': 'non-finite output',
        }))
        return 1

    elapsed, spread_pct = _rate_stats(lambda: batched(params), n_iter)
    spectra_per_s = batch / elapsed
    _stage('flagship: measured')

    _stage('reference C baseline')
    # Reference C baseline (per host core x core count):
    try:
        base_core = reference_c_baseline(nwave, model.nlayers, n_eval=10)
    except Exception:
        base_core = None
    ncores = os.cpu_count() or 1
    vs_baseline = None
    if base_core is not None:
        vs_baseline = spectra_per_s / (base_core * ncores)

    # The compiled program's own bytes and FLOPs per forward; a
    # roofline share needs the peak table this bench does not have yet:
    extras = {
        'bytes_per_forward_mb': round(bytes_per_batch / batch / 1e6, 2),
        'flops_per_forward_mflop': round(flops_per_batch / batch / 1e6, 2),
    }
    # Secondary: direct line-by-line sampling + tabulation throughput:
    _stage('lbl rates')
    try:
        extras.update(_lbl_rates())
    except Exception as exc:
        extras['lbl_error'] = f'{type(exc).__name__}: {exc}'[:120]
    # Secondary: high-resolution forward model (R = 25,000):
    _stage('highres rate')
    try:
        extras.update(_highres_rate())
    except Exception as exc:
        extras['highres_error'] = f'{type(exc).__name__}: {exc}'[:120]
    # Secondary: eclipse-retrieval rate (batched emission ensemble):
    _stage('emission retrieval rate')
    try:
        extras.update(_emission_retrieval_rate())
    except Exception as exc:
        extras['emission_retrieval_error'] = (
            f'{type(exc).__name__}: {exc}'[:120])
    # Secondary: high-res retrieval rate (batched hires channel):
    _stage('hires retrieval rate')
    try:
        extras.update(_hires_retrieval_rate())
    except Exception as exc:
        extras['hires_retrieval_error'] = (
            f'{type(exc).__name__}: {exc}'[:120])
    # Secondary: radiative-equilibrium iteration rate (runmode=radeq):
    _stage('radeq rate')
    try:
        extras.update(_radeq_rate())
    except Exception as exc:
        extras['radeq_error'] = f'{type(exc).__name__}: {exc}'[:120]
    # Batch x grid throughput curve (single chip):
    if os.environ.get('PBT_BENCH_CURVES', '1') != '0':
        _stage('throughput curve')
        try:
            extras['throughput_curve'] = _throughput_curve()
        except Exception as exc:
            extras['curve_error'] = f'{type(exc).__name__}: {exc}'[:120]
    # Production-scale workloads (SURVEY sizes):
    if os.environ.get('PBT_BENCH_PRODUCTION', '1') != '0':
        _stage('production table (~1.2e9 pts)')
        try:
            extras.update(_production_table())
        except Exception as exc:
            extras['production_table_error'] = (
                f'{type(exc).__name__}: {exc}'[:200])
        _stage('production retrieval (1024 chains)')
        try:
            extras.update(_production_retrieval())
        except Exception as exc:
            extras['production_retrieval_error'] = (
                f'{type(exc).__name__}: {exc}'[:200])
    # Wave-sharding scaling efficiency (CPU virtual devices, fixed
    # total work; see pyratbay_tpu/scaling_probe.py):
    if os.environ.get('PBT_BENCH_SCALING', '1') != '0':
        _stage('scaling efficiency (CPU)')
        try:
            extras['scaling'] = _scaling_efficiency()
        except Exception as exc:
            extras['scaling_error'] = f'{type(exc).__name__}: {exc}'[:120]

    print(json.dumps({
        'metric': f'forward-model throughput (batch={batch}, '
                  f'{model.nlayers}x{nwave} grid, f32)',
        'platform': device.platform,
        'device_kind': device.device_kind,
        'device_count': len(jax.devices()),
        'value': round(spectra_per_s, 1),
        'value_spread_pct': spread_pct,
        'unit': 'spectra/s',
        'vs_baseline': (
            None if vs_baseline is None else round(vs_baseline, 2)
        ),
        'baseline_c_per_core': (
            None if base_core is None else round(base_core, 1)
        ),
        'baseline_cores': ncores,
        'single_chip': True,
        **extras,
    }))
    return 0


def _lbl_rates(n_iter=50, block=8):
    """DirectLBL pair rate (8-cell blocks, the tabulation workload)
    plus full tabulate() throughput.

    Reported rates:
      * lbl_line_pairs_per_s -- padded candidate-window pairs;
      * lbl_effective_pairs_per_s -- pairs inside the physical cutoff
        window only (the work the reference's C kernel would do,
        src_c/_extcoeff.c:270-308); the ratio is the masked-work
        overhead of the static-tile formulation."""
    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import synthetic_lines
    from pyratbay_tpu.opacity.lbl_tpu import DirectLBL

    lines = synthetic_lines()
    direct = DirectLBL(lines, tile=128)
    temps = np.linspace(700.0, 2900.0, block)
    vmr = np.array([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4,
                    1e-7])
    dens = vmr[None, :] * (
        np.logspace(-4, 1, block)[:, None] * 1.01e6
        / (1.380649e-16 * temps[:, None])
    )
    pf = lines.iso_pf(temps).T

    # Measured as an 8-block lax.map sweep (how tabulate() runs):
    from jax import lax
    nblk = 8
    tb = direct.tables()
    t_all = np.tile(temps, nblk).reshape(nblk, block)
    d_all = np.tile(dens, (nblk, 1)).reshape(nblk, block, -1)
    p_all = np.tile(pf, (nblk, 1)).reshape(nblk, block, -1)
    sweep = jax.jit(lambda t, d, p: jnp.sum(lax.map(
        lambda a: direct._cross_section_batch(tb, *a), (t, d, p),
    )))
    sweep_args = (
        jnp.asarray(t_all, jnp.float32),
        jnp.asarray(d_all, jnp.float32),
        jnp.asarray(p_all, jnp.float32),
    )
    dt_sweep, spread_pct = _rate_stats(
        lambda: sweep(*sweep_args), n_iter)
    dt = dt_sweep / nblk
    # Padded pairs: the wing and core passes' candidate windows:
    pairs = block * (
        direct.ntiles * direct.tile * direct.lmax
        + direct.ntiles_core * direct.tile_core * direct.lmax_core
    )
    line_density = len(lines.lwn) / (lines.lwn[-1] - lines.lwn[0])
    eff_pairs = (
        block * direct.nwave * 2.0 * direct.cutoff * line_density
    )
    rates = {
        'lbl_line_pairs_per_s': round(pairs / dt / 1e9, 2),
        'lbl_effective_pairs_per_s': round(float(eff_pairs / dt / 1e9), 2),
        'lbl_rate_spread_pct': spread_pct,
        'lbl_grid_points_per_s': round(block * direct.nwave / dt, 1),
    }

    # Full opacity-tabulation throughput (10 T x 51 layers).  The
    # first call compiles the sweep program; the second is timed end
    # to end, table fetch included.
    press = np.logspace(-6, 2, 51)
    tab_temps = np.linspace(300.0, 3000.0, 10)
    vmr_prof = np.tile(vmr, (51, 1))
    start = time.perf_counter()
    direct.tabulate(tab_temps, press, vmr_prof)  # compile + run
    dt_compile = time.perf_counter() - start
    start = time.perf_counter()
    table = direct.tabulate(tab_temps, press, vmr_prof)
    dt_tab = time.perf_counter() - start
    npoints = table.size

    # The device rate times the same sweep program reduced to a
    # scalar, so no table is fetched:
    sweep = direct._sweep
    tbl = direct.tables()
    cells_t = np.repeat(tab_temps, 51).astype(np.float32)
    dens_c = (vmr_prof[None].repeat(10, 0).reshape(510, -1)
              * (np.tile(press, 10)[:, None] * 1.01325e6
                 / (1.380649e-16 * cells_t[:, None]))).astype(np.float32)
    pf_c = lines.iso_pf(cells_t).T.astype(np.float32)
    tab_block = 64  # tabulate()'s default: reuses its compiled sweep
    nb = -(-510 // tab_block)
    pad = nb * tab_block - 510
    targs3 = tuple(
        jnp.asarray(np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                           mode='edge')
                    .reshape(nb, tab_block, -1).squeeze())
        for a in (cells_t, dens_c, pf_c)
    )
    dev_fn = jax.jit(lambda: jnp.sum(sweep(tbl, *targs3)))
    dt_dev, tab_spread = _rate_stats(dev_fn, max(3, n_iter // 10))
    rates['tabulation_points_per_s'] = round(npoints / dt_dev, 1)
    rates['tabulation_rate_spread_pct'] = tab_spread
    rates['tabulation_device_seconds'] = round(dt_dev, 3)
    rates['tabulation_with_fetch_seconds'] = round(dt_tab, 2)
    rates['tabulation_with_fetch_points_per_s'] = round(
        npoints / dt_tab, 1)
    rates['tabulation_compile_seconds'] = round(dt_compile, 2)
    return rates


def _throughput_curve(n_iter=20):
    """Batch x grid throughput points (spectra/s) on this device.

    Grids: wnstep=1 (~3.2k), R=25k (~10.9k), R=115k (~50k points over
    1.1-1.7 um).  Combos whose vmapped intermediates exceed the HBM
    budget are skipped and listed in 'skipped' (no silent caps).

    Every (grid, batch) point is a separate XLA program, so the
    default sweep is one representative batch per grid (big batch on
    the small grid, small batch on the big grid).  PBT_BENCH_CURVES=
    full restores the 3x3 matrix.
    """
    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import make_flagship

    full = os.environ.get('PBT_BENCH_CURVES') == 'full'
    grids = [
        ('wnstep1', dict(wnstep=1.0), [64, 512, 4096] if full
            else [2048]),
        ('R25k', dict(wnstep=None, resolution=25000.0),
            [64, 512, 4096] if full else [512]),
        ('R115k', dict(wnstep=None, resolution=115000.0),
            [64, 512, 4096] if full else [64]),
    ]
    hbm_budget = 10e9
    points = []
    skipped = []
    from pyratbay_tpu.retrieval.batched import build_forward_batched
    for gname, gkw, batches in grids:
        model, obs, ret, forward, p0 = make_flagship(**gkw)
        forward_b = build_forward_batched(model, obs, ret)
        batched = jax.jit(lambda p: forward_b(p)['bandflux'])
        rng = np.random.default_rng(4)
        for batch in batches:
            # ~4 [L, W] f32 intermediates per chain in flight:
            est_bytes = batch * model.nlayers * model.nwave * 4 * 4
            if est_bytes > hbm_budget:
                skipped.append({
                    'grid': gname, 'batch': batch,
                    'reason': f'est {est_bytes / 1e9:.1f} GB > HBM budget',
                })
                continue
            params = jnp.asarray(
                (np.tile(p0, (batch, 1))
                 + 0.01 * rng.standard_normal((batch, len(p0)))
                 ).astype(np.float32),
            )
            dt = _rate(lambda: batched(params), n_iter)
            points.append({
                'grid': gname, 'nwave': int(model.nwave), 'batch': batch,
                'spectra_per_s': round(batch / dt, 1),
                'wave_points_per_s': round(batch * model.nwave / dt, 1),
            })
    return {'points': points, 'skipped': skipped}


def _probe_run(n, resolution=None, batch=8, iters=5, passes=2,
               timeout=900):
    """One scaling_probe subprocess -> dict (or {'error': ...})."""
    import json as _json
    import subprocess

    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    env.pop('XLA_FLAGS', None)
    env['PBT_PROBE_BATCH'] = str(batch)
    env['PBT_PROBE_ITERS'] = str(iters)
    env['PBT_PROBE_PASSES'] = str(passes)
    cmd = [sys.executable, '-m', 'pyratbay_tpu.scaling_probe', str(n)]
    if resolution:
        cmd.append(str(resolution))
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout else ''
    if proc.returncode != 0 or not line.startswith('{'):
        return {'error': (proc.stderr or 'no output')[-200:]}
    return _json.loads(line)


def _scaling_efficiency(device_counts=(1, 2, 4, 8)):
    """Wave-sharding efficiency on N virtual CPU devices.

    Strong scaling (fixed work, R115k grid: ~6.3k wave pts/shard at
    N=8 -- round 3 probed the small flagship grid, 401 pts/shard,
    where GSPMD overhead dominated) and weak scaling (R = 15k x N, so
    per-shard work is constant).  Physical host cores are recorded:
    with virtual devices on an oversubscribed host, efficiency
    measures the sharded-program overhead, not hardware speedup.
    """
    try:
        physical = len(os.sched_getaffinity(0))
    except AttributeError:
        physical = os.cpu_count()

    def block(counts, res_of_n, weak=False):
        times, eff, shard_pts = {}, {}, {}
        for n in counts:
            r = _probe_run(n, resolution=res_of_n(n))
            if 'error' in r:
                times[str(n)] = r
                continue
            times[str(n)] = round(r['sec_per_batch'], 5)
            shard_pts[str(n)] = r['wave_pts_per_shard']
        base = times.get('1')
        if isinstance(base, float):
            for n in counts:
                t_n = times.get(str(n))
                if isinstance(t_n, float):
                    # Strong (fixed work): ideal keeps t constant ->
                    # t1/tN.  Weak (work ~ N on the SAME oversubscribed
                    # host): ideal processes N units in N*t1 ->
                    # N*t1/tN (a plain t1/tN would conflate host
                    # throughput with sharding overhead).
                    ideal = base * n if weak else base
                    eff[str(n)] = round(ideal / t_n, 3)
        return {
            'sec_per_batch': times,
            'efficiency_vs_1dev': eff,
            'wave_pts_per_shard': shard_pts,
        }

    out = {
        'mode': 'wave sharding (virtual CPU devices)',
        'host_logical_cpus': os.cpu_count(),
        'host_affinity_cpus': physical,
        # What these numbers can and cannot show: N virtual devices
        # share the host cores above, so 'efficiency' here measures
        # GSPMD sharding OVERHEAD (ideal = 1.0 means partitioning
        # adds no cost), NOT hardware speedup -- real multi-chip
        # scaling is unknowable on this 1-chip host.  Strong: fixed
        # R115k work, ideal keeps sec_per_batch flat.  Weak: work
        # grows ~N on the same cores, ideal is N*t1/tN:
        'interpretation': (
            'efficiency == sharded-program overhead on an '
            'oversubscribed host, not multi-chip speedup'
        ),
        'strong_R115k': block(device_counts, lambda n: 115000.0),
        'weak_R15k_per_dev': block(
            device_counts, lambda n: 15000.0 * n, weak=True),
    }
    try:
        out['multiprocess_2x4'] = _multiproc_throughput()
    except Exception as exc:
        out['multiprocess_2x4'] = {
            'error': f'{type(exc).__name__}: {exc}'[:200]}
    return out


def _multiproc_throughput(timeout=900):
    """2 processes x 4 virtual devices: jax.distributed throughput of
    the wave-sharded log-posterior ensemble (parallel/mp_probe.py)."""
    import json as _json
    import subprocess

    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    env.pop('XLA_FLAGS', None)
    proc = subprocess.run(
        [sys.executable, '-m', 'pyratbay_tpu.parallel.mp_probe'],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout else ''
    if proc.returncode != 0 or not line.startswith('{'):
        return {'error': (proc.stderr or 'no output')[-200:]}
    return _json.loads(line)


def _radeq_rate(nsamples=250):
    """Radiative-equilibrium iterations per second (runmode=radeq).

    The whole adaptive loop (wobble-damped dT, smoothing) runs as one
    device lax.scan in 25-iteration chunks (spectrum/radeq.py).
    """
    from pyratbay_tpu.benchmark import make_radeq
    from pyratbay_tpu.spectrum.radeq import radiative_equilibrium

    model = make_radeq()
    # Warm-up: compiles the chunked scan (one 25-iteration program).
    radiative_equilibrium(model, nsamples=25)
    start = time.perf_counter()
    radiative_equilibrium(
        model, nsamples=nsamples,
        radeq_temps=model.radeq_temps, dt_scale=model._dt_scale,
    )
    dt = time.perf_counter() - start
    return {
        'radeq_iters_per_s': round(nsamples / dt, 2),
        'radeq_nlayers': int(model.nlayers),
        'radeq_nwave': int(model.nwave),
    }


def _production_table(nspec=5, ntemp=24, nlayers=51, nwave=200_000):
    """Production-scale opacity tabulation: nspec independent
    line-list tables over (ntemp x nlayers x nwave) -- ~1.2e9 grid
    points at the defaults (the SURVEY-scale workload; the small
    tabulation probe above is a 1.6M-point sample).

    Wall-clock covers the full device sweep of every (T, layer) cell
    of every species, ended by block_until_ready (production tables
    stream to npz per species).  Compile time is reported separately
    (one program serves all species).
    """
    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import synthetic_lines
    from pyratbay_tpu.opacity.lbl_tpu import DirectLBL

    block = 8
    press = np.logspace(-6, 2, nlayers)
    temps = np.linspace(300.0, 3000.0, ntemp)
    vmr = np.array([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4,
                    1e-7])
    cells_t = np.repeat(temps, nlayers)
    press_cells = np.tile(press, ntemp)
    ncells = ntemp * nlayers
    nblocks = -(-ncells // block)
    npad = nblocks * block - ncells
    cells_t = np.pad(cells_t, (0, npad), mode='edge')
    press_cells = np.pad(press_cells, (0, npad), mode='edge')

    t_compile = 0.0
    t0_all = time.perf_counter()
    # Every block's output stays device-resident until the end, as a
    # real tabulation keeps or streams every [block, nspec, nwave]
    # result: nspec * ncells * nwave * 4 B ~ 4.9 GB:
    resident = []
    for ispec in range(nspec):
        lines = synthetic_lines(seed=ispec)
        lines.wn = np.linspace(5882.0, 9091.0, nwave)
        direct = DirectLBL(lines, tile=128)
        dens = vmr[None, :] * (
            press_cells[:, None] * 1.01325e6
            / (1.380649e-16 * cells_t[:, None])
        )
        pf = lines.iso_pf(cells_t).T
        batched = jax.jit(direct._cross_section_batch)
        tbl = jax.device_put(direct.tables())
        for lo in range(0, nblocks * block, block):
            t_args = (
                jnp.asarray(cells_t[lo:lo + block], jnp.float32),
                jnp.asarray(dens[lo:lo + block], jnp.float32),
                jnp.asarray(pf[lo:lo + block], jnp.float32),
            )
            if ispec == 0 and lo == 0:
                t_c = time.perf_counter()
                out = batched(tbl, *t_args)
                jax.block_until_ready(out)
                t_compile = time.perf_counter() - t_c
                resident.append(out)
            else:
                resident.append(batched(tbl, *t_args))
    jax.block_until_ready(resident)
    wall = time.perf_counter() - t0_all - t_compile
    n_resident = len(resident)
    del resident
    points = nspec * ntemp * nlayers * nwave
    return {
        'production_table': {
            'nspec': nspec, 'ntemp': ntemp, 'nlayers': nlayers,
            'nwave': nwave, 'points': points,
            'device_resident_blocks': n_resident,
            'device_seconds': round(wall, 1),
            'compile_seconds': round(t_compile, 1),
            'points_per_s': round(points / wall, 1),
        },
    }


def _production_retrieval(nchains=1024, chunk_gens=500, max_chunks=70,
                          gr_target=1.01):
    """End-to-end retrieval at production ensemble size: 1024 DEMC
    chains on the flagship model against WFC3-grade synthesized
    observations (30 ppm), run in 500-generation chunks with
    acceptance-adaptive DE steps until the Gelman-Rubin factor over a
    sliding 2000-generation window drops below 1.01 (or the cap).
    """
    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval import sample_demc
    from pyratbay_tpu.retrieval.batched import (
        build_log_posterior_batched,
    )

    def gr_np(hist):
        """Gelman-Rubin on host numpy over the fetched history."""
        ngen, nchains_, _ = hist.shape
        cmeans = hist.mean(axis=0)
        gmean = cmeans.mean(axis=0)
        between = ngen / (nchains_ - 1) * ((cmeans - gmean)**2).sum(0)
        within = hist.var(axis=0, ddof=1).mean(axis=0)
        var_est = (ngen - 1) / ngen * within + between / ngen
        return np.sqrt(var_est / np.where(within > 0, within, 1.0))

    model, obs, ret, forward, p0 = make_flagship()
    if obs.data is None:
        band = np.asarray(jax.jit(forward)(jnp.asarray(p0))['bandflux'])
        rng = np.random.default_rng(11)
        obs.data = band + rng.normal(0.0, 3e-5, band.shape)
        obs.uncert = np.full(band.shape, 3e-5)
    from pyratbay_tpu.retrieval import build_log_posterior
    log_post = build_log_posterior(model, obs, ret)
    log_post_b = jax.jit(build_log_posterior_batched(model, obs, ret))

    # Warm-started ensemble (tight around the truth): the bench
    # measures stationary sampling throughput + convergence
    # confirmation, not burn-in length from a cold prior:
    rng = np.random.default_rng(12)
    pstep = np.asarray(ret.pstep, float)
    init = (
        np.tile(np.asarray(p0), (nchains, 1))
        + 0.05 * pstep * rng.standard_normal((nchains, len(p0)))
    )
    chains = jnp.asarray(np.clip(init, ret.pmin, ret.pmax))
    hist = []
    t_start = time.perf_counter()
    t_sustained = None
    gens = 0
    grfactor = None
    gamma = None
    acc = None
    for chunk in range(max_chunks):
        results = sample_demc(
            log_post,
            chains,
            nsamples=nchains * chunk_gens,
            key=jax.random.PRNGKey(100 + chunk),
            nchains=nchains,
            pstep=ret.pstep, pmin=ret.pmin, pmax=ret.pmax,
            log_post_batched=log_post_b,
            adapt_gamma=True, target_acceptance=0.10,
            gamma_init=gamma,
        )
        chains = results['chains']
        gamma = results['gamma_final']
        acc = float(np.asarray(results['acceptance_rate']))
        gens += np.asarray(results['chain_history']).shape[0]
        # GR window: every 5th generation of the last <= 30k (the
        # sliding-window GR floor is ~1 + c*tau/window; the previous
        # 15k window bottomed out at ~1.016 with tau ~ 1e2):
        hist.append(np.asarray(results['chain_history'])[::5])
        if t_sustained is None:
            t_sustained = time.perf_counter()   # excl. first-chunk compile
            gens_at_sustained = gens
        hist = hist[-60:]
        window = np.concatenate(hist, axis=0)
        grfactor = float(np.max(gr_np(window)))
        if grfactor < gr_target and chunk >= 1:
            break
        budget = float(os.environ.get('PBT_BENCH_RET_BUDGET', 540.0))
        if time.perf_counter() - t_start > budget:
            break  # honest cap: 'converged' stays False
    wall = time.perf_counter() - t_start
    sustained = time.perf_counter() - t_sustained
    sus_gens = gens - gens_at_sustained
    return {
        'production_retrieval': {
            'nchains': nchains,
            'generations': gens,
            'gelman_rubin_max': round(grfactor, 4),
            'gr_window_gens': 60 * 500,
            'gr_window_thin': 5,
            'acceptance_rate': (
                None if acc is None else round(acc, 3)),
            'converged': bool(grfactor < gr_target),
            'wall_seconds': round(wall, 1),
            'chain_evals_per_s': (
                round(nchains * sus_gens / sustained, 1)
                if sus_gens > 0 else None
            ),
        },
    }


def _emission_retrieval_rate(n_iter=20, batch=256):
    """Eclipse-retrieval chain evaluations per second on the batched
    hot path (plane-parallel emission ensemble, retrieval/batched.py)."""
    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.batched import (
        build_log_posterior_batched,
    )

    model, obs, ret, forward, p0 = make_flagship(rt_path='eclipse')
    if obs.data is None:
        band = np.asarray(jax.jit(forward)(jnp.asarray(p0))['bandflux'])
        obs.data = band
        obs.uncert = np.maximum(np.abs(band) * 0.03, 1e-12)
    log_post_b = build_log_posterior_batched(model, obs, ret)
    assert not getattr(log_post_b, 'is_fallback', False)
    batched = jax.jit(log_post_b)
    rng = np.random.default_rng(3)
    params = jnp.asarray((
        np.tile(p0, (batch, 1))
        + 0.01 * rng.standard_normal((batch, len(p0)))
    ).astype(np.float32))
    dt, spread = _rate_stats(lambda: batched(params), n_iter)
    return {
        'emission_retrieval_evals_per_s': round(batch / dt, 1),
        'emission_retrieval_spread_pct': spread,
    }


def _hires_retrieval_rate(n_iter=20, batch=64):
    """High-res retrieval (instrumental convolution + retrieved RV +
    resampled likelihood) on the batched hot path -- round 4 forced
    the vmap fallback for any hires channel."""
    import tempfile

    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.io import io as pio
    from pyratbay_tpu.observation import Observation
    from pyratbay_tpu.retrieval import RetrievalParams
    from pyratbay_tpu.retrieval.batched import (
        build_log_posterior_batched,
    )

    workdir = tempfile.mkdtemp(prefix='pbt_hires_ret_')
    model, obs0, ret0, fwd0, p0 = make_flagship(workdir)
    wl_hires = np.linspace(1.15, 1.65, 4000)
    hires_file = workdir + '/hires_obs.dat'
    pio.write_observations(
        hires_file, np.full(4000, 0.0066), np.full(4000, 1e-4),
        [f'{wl:.6f} 0.0001 HIRES' for wl in wl_hires],
    )
    cfg = model.cfg
    cfg.obsfile_hires = hires_file
    cfg.inst_resolution = 25000.0
    cfg.retrieval_params = cfg.retrieval_params + \
        '\n    rv_shift   10.0  -100.0  100.0  5.0'
    obs = Observation(cfg, model.wn)
    ret = RetrievalParams(model, obs)
    log_post_b = build_log_posterior_batched(model, obs, ret)
    batched = jax.jit(log_post_b)
    rng = np.random.default_rng(4)
    params = jnp.asarray((
        np.tile(np.asarray(ret.params), (batch, 1))
        + 0.01 * rng.standard_normal((batch, len(ret.params)))
    ).astype(np.float32))
    dt, spread = _rate_stats(lambda: batched(params), n_iter)
    return {
        'hires_retrieval_evals_per_s': round(batch / dt, 1),
        'hires_retrieval_spread_pct': spread,
        'hires_retrieval_npoints': 4000,
    }


def _highres_rate(n_iter=20, batch=64):
    """Flagship forward at R = 25,000 (realistic high-res grid)."""
    import jax
    import jax.numpy as jnp
    from pyratbay_tpu.benchmark import make_flagship

    from pyratbay_tpu.retrieval.batched import build_forward_batched
    model, obs, ret, forward, p0 = make_flagship(
        wnstep=None, resolution=25000.0,
    )
    forward_b = build_forward_batched(model, obs, ret)
    batched = jax.jit(lambda p: forward_b(p)['bandflux'])
    rng = np.random.default_rng(2)
    params = jnp.asarray((
        np.tile(p0, (batch, 1))
        + 0.01 * rng.standard_normal((batch, len(p0)))
    ).astype(np.float32))
    dt = _rate(lambda: batched(params), n_iter)
    return {
        'highres_spectra_per_s': round(batch / dt, 1),
        'highres_nwave': model.nwave,
    }


if __name__ == '__main__':
    sys.exit(main())
