"""Benchmark harness: self-contained flagship models and reference
C-kernel baselines.

The flagship workload is the BASELINE.json config-1 shape: an
HD 209458 b-like transmission spectrum with line-sampled H2O, H2-H2
CIA, Na alkali, Rayleigh, and a cloud deck + haze, 51 layers x ~3209
wavenumbers, evaluated as a jitted retrieval forward (the hot loop of
an MCMC retrieval).

Everything is generated programmatically (synthetic opacity tables in
the real file formats), so benchmarks and the graft entry run without
external data.
"""
import os
import tempfile

import numpy as np

from . import constants as pc
from .config.parser import Config
from .io import io as pio

__all__ = ['make_flagship', 'synthetic_lines', 'reference_c_baseline']


def _synthetic_cs_table(path, wn, press, species='H2O', ntemp=10, seed=5):
    """Write a synthetic line-sampled cross-section npz (real format)."""
    rng = np.random.default_rng(seed)
    temps = np.linspace(300.0, 3000.0, ntemp)
    nlayers = len(press)
    nwave = len(wn)
    # Smooth band structure + pseudo lines, pressure-broadened:
    band = 1e-22 * np.exp(
        -0.5 * ((wn - wn.mean()) / (0.2 * np.ptp(wn)))**2
    )
    lines = np.zeros(nwave)
    nlines = min(400, max(nwave // 4, 1))
    line_pos = rng.choice(nwave, nlines, replace=False)
    lines[line_pos] = rng.lognormal(0.0, 1.5, nlines) * 1e-21
    opacity = np.zeros((ntemp, nlayers, nwave))
    for it, temp in enumerate(temps):
        tfac = (temp / 1000.0)**-0.5
        for il, pres in enumerate(press):
            width = 1 + int(3 * np.log10(1 + pres / press[0]))
            smooth = np.convolve(
                lines, np.ones(width) / width, mode='same',
            )
            opacity[it, il] = tfac * (band + smooth)
    pio.write_opacity(path, species, temps, press, wn, opacity)
    return path


def _synthetic_cia_table(path, species=('H2', 'H2'), seed=7):
    """Write a synthetic CIA table in the standard text format."""
    rng = np.random.default_rng(seed)
    temps = np.linspace(60.0, 3000.0, 15)
    wn = np.linspace(20.0, 16000.0, 200)
    base = 1e-7 * np.exp(-0.5 * ((wn - 5000) / 4000)**2)
    cs = np.array([
        base * (temp / 1000.0)**-0.7 * (1 + 0.1 * rng.random(len(wn)))
        for temp in temps
    ])
    pio.write_cs(path, cs, list(species), temps, wn)
    return path


def make_flagship(workdir=None, nlayers=51, wl_low=1.1, wl_high=1.7,
                  wnstep=1.0, resolution=None, rt_path='transit'):
    """Build the flagship model + retrieval forward.

    Sampling: constant-dnu `wnstep` (default), or constant-R
    `resolution` when given (wnstep ignored).  rt_path picks the
    geometry ('transit' default; 'eclipse' / 'emission' build the
    same atmosphere over the plane-parallel solver).
    Returns (model, obs, ret, forward_fn, example_params).
    """
    import jax
    import jax.numpy as jnp
    from .model import Model
    from .observation import Observation
    from .retrieval import RetrievalParams, build_forward

    if workdir is None:
        workdir = tempfile.mkdtemp(prefix='pbt_flagship_')
    os.makedirs(workdir, exist_ok=True)

    press = np.logspace(-6, 2, nlayers)
    species = ['H2', 'He', 'H', 'Na', 'K', 'H2O', 'CH4', 'CO', 'CO2']
    vmr = np.tile(
        [8.5e-1, 1.49e-1, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7],
        (nlayers, 1),
    )
    temp = np.full(nlayers, 1400.0)
    atmfile = os.path.join(workdir, 'flagship.atm')
    pio.write_atm(atmfile, press, temp, species, vmr, punits='bar')

    if resolution is not None:
        # Constant-R geometric grid (spec_tools.py:461-505 semantics):
        from .ops.grids import wavenumber_grid
        wn = np.asarray(wavenumber_grid(
            wnlow=1.0 / (wl_high * 1e-4), wnhigh=1.0 / (wl_low * 1e-4),
            resolution=resolution,
        ).wn)
    else:
        wn = np.arange(
            1.0 / (wl_high * 1e-4), 1.0 / (wl_low * 1e-4), wnstep,
        )
    cs_file = os.path.join(workdir, 'flagship_h2o.npz')
    _synthetic_cs_table(cs_file, wn, press)
    cia_file = os.path.join(workdir, 'flagship_cia.dat')
    _synthetic_cia_table(cia_file)

    sampling_key = (
        f'resolution = {resolution}' if resolution is not None
        else f'wnstep = {wnstep}'
    )
    cfg_text = f"""[pyrat]
runmode = spectrum
verb = -1
logfile = {workdir}/flagship.log
rt_path = {rt_path}
atmfile = {atmfile}
sampled_cross_sec = {cs_file}
continuum_cross_sec = {cia_file}
wl_low = {wl_low} um
wl_high = {wl_high} um
{sampling_key}
rstar = 1.27 rsun
tstar = 5800.0
smaxis = 0.045 au
mplanet = 0.6 mjup
rplanet = 1.0 rjup
refpressure = 0.1 bar
radmodel = hydro_m
maxdepth = 10.0
tmodel = guillot
tpars = -4.67 -0.8 -0.8 0.5 1486.0 100.0
vmr_vars = log_H2O -3.4
bulk = H2 He
alkali = sodium_vdw
clouds =
    deck 2.0
    lecavelier 0.0 -4.0
tlow = 300
thigh = 3000
retrieval_params =
    log_kappa'   -4.67  -9.0  5.0  0.3
    T_irr      1486.0  100.0 3000.0 50.0
    log_H2O      -3.4   -9.0 -1.0  0.5
    R_planet      1.0    0.5  4.5  0.03
    log_p_cl      2.0   -6.0  2.0  0.5
    log_k_ray     0.0   -4.0  4.0  0.5
    alpha_ray    -4.0   -6.0  0.0  0.0
"""
    cfg_file = os.path.join(workdir, 'flagship.cfg')
    with open(cfg_file, 'w') as f:
        f.write(cfg_text)

    model = Model(cfg_file)

    class _ObsCfg:
        data = None
        uncert = None
        filters = [
            f'tophat {wl0:.4f} 0.01'
            for wl0 in np.linspace(wl_low + 0.03, wl_high - 0.03, 20)
        ]
        obsfile = None
        dunits = None
        offset_inst = None
        uncert_scaling = None

    obs = Observation(_ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    forward = build_forward(model, obs, ret)
    example_params = np.asarray(ret.params)
    return model, obs, ret, forward, example_params


def synthetic_lines(nlines=50_000, seed=0):
    """Synthetic H2O-like line list over the flagship band (the LBL
    and tabulation workload): the DirectLBL input interface."""
    rng = np.random.default_rng(seed)

    class _Lines:
        wn = np.arange(5882.0, 9091.0, 1.0)
        lwn = np.sort(rng.uniform(5800.0, 9200.0, nlines))
        gf = rng.lognormal(-8, 3, nlines)
        elow = rng.uniform(0, 15000, nlines)
        isoid = rng.integers(0, 4, nlines)
        iso_mass = np.array([18.011, 20.015, 19.015, 19.017])
        iso_ratio = np.array([0.997, 2e-3, 3.7e-4, 3.1e-4])
        iso_spec_index = np.zeros(4, int)
        iso_atm_index = np.full(4, 5)
        nspec = 1
        mol_radius = np.array(
            [1.445, 1.4, 1.1, 2.2, 2.8, 1.6, 2.0, 1.9, 1.97]) * 1e-8
        mol_mass = np.array(
            [2.016, 4.003, 1.008, 22.99, 39.098, 18.015, 16.04, 28.01,
             44.01])
        cutoff = 25.0
        tmin = 100.0
        tmax = 3000.0

        @staticmethod
        def iso_pf(t):
            t = np.atleast_1d(t)
            return np.tile(174.0 * (t / 296.0)**1.5, (4, 1))

    return _Lines()


def make_radeq(workdir=None, nlayers=40, wl_low=0.6, wl_high=12.0,
               resolution=300.0):
    """Self-contained radiative-equilibrium model (runmode=radeq).

    Same synthetic opacity inputs as the flagship, but an
    emission_two_stream geometry over a broad (bolometric) constant-R
    grid -- the reference's radeq workload
    (pyratbay/spectrum/radiative_transfer.py:141-274).
    """
    import tempfile

    from .model import Model
    from .io import io as pio

    if workdir is None:
        workdir = tempfile.mkdtemp(prefix='pbt_radeq_')
    os.makedirs(workdir, exist_ok=True)

    press = np.logspace(-6, 2, nlayers)
    species = ['H2', 'He', 'H', 'Na', 'K', 'H2O', 'CH4', 'CO', 'CO2']
    vmr = np.tile(
        [8.5e-1, 1.49e-1, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7],
        (nlayers, 1),
    )
    temp = np.full(nlayers, 1400.0)
    atmfile = os.path.join(workdir, 'radeq.atm')
    pio.write_atm(atmfile, press, temp, species, vmr, punits='bar')

    from .ops.grids import wavenumber_grid
    wn = np.asarray(wavenumber_grid(
        wnlow=1.0 / (wl_high * 1e-4), wnhigh=1.0 / (wl_low * 1e-4),
        resolution=resolution,
    ).wn)
    cs_file = os.path.join(workdir, 'radeq_h2o.npz')
    _synthetic_cs_table(cs_file, wn, press)
    cia_file = os.path.join(workdir, 'radeq_cia.dat')
    _synthetic_cia_table(cia_file)

    cfg_text = f"""[pyrat]
runmode = radeq
verb = -1
logfile = {workdir}/radeq.log
rt_path = emission_two_stream
atmfile = {atmfile}
sampled_cross_sec = {cs_file}
continuum_cross_sec = {cia_file}
wl_low = {wl_low} um
wl_high = {wl_high} um
resolution = {resolution}
rstar = 1.27 rsun
tstar = 5800.0
smaxis = 0.045 au
mplanet = 0.6 mjup
rplanet = 1.0 rjup
refpressure = 0.1 bar
radmodel = hydro_m
tmodel = guillot
tpars = -4.67 -0.8 -0.8 0.5 1486.0 100.0
bulk = H2 He
tlow = 100
thigh = 5900
"""
    cfg_file = os.path.join(workdir, 'radeq.cfg')
    with open(cfg_file, 'w') as f:
        f.write(cfg_text)
    return Model(cfg_file)


def reference_c_baseline(nwave, nlayers, n_eval=20):
    """Time the reference's C forward-model path on this host CPU.

    Builds the reference C extensions out-of-tree (gcc -O3 -ffast-math,
    same flags as its setup.py) and times one forward evaluation of the
    flagship shape: line-sample T-interpolation + alkali + CIA interp +
    per-impact-parameter optical depth + transmission integral.

    Returns spectra/s per core, or None when the toolchain or reference
    sources are unavailable.
    """
    import glob
    import subprocess
    import sys
    import sysconfig
    import time

    src = '/root/reference/src_c'
    if not os.path.isdir(src):
        return None
    out = tempfile.mkdtemp(prefix='refc_')
    inc_py = sysconfig.get_paths()['include']
    import numpy
    inc_np = numpy.get_include()
    for cfile in glob.glob(f'{src}/*.c'):
        name = os.path.splitext(os.path.basename(cfile))[0]
        cmd = [
            'gcc', '-shared', '-fPIC', '-O3', '-ffast-math',
            f'-I{src}/include', f'-I{inc_py}', f'-I{inc_np}',
            cfile, '-o', f'{out}/{name}.so', '-lm',
        ]
        result = subprocess.run(cmd, capture_output=True)
        if result.returncode != 0:
            return None
    sys.path.insert(0, out)
    try:
        import _extcoeff as ec
        import _trapezoid as t
        import _alkali
        import _spline as sp
    finally:
        sys.path.remove(out)

    rng = np.random.default_rng(0)
    ntemp = 10
    nmol = 1
    press = np.logspace(-6, 2, nlayers)
    temp_profile = np.linspace(1200.0, 1600.0, nlayers)
    etable = rng.random((nmol, ntemp, nlayers, nwave)) * 1e-22
    ttable = np.linspace(300.0, 3000.0, ntemp)
    density = rng.random((nlayers, nmol)) * 1e16
    radius = np.linspace(1.06, 0.99, nlayers) * pc.rjup
    wn = np.linspace(5882.0, 9091.0, nwave)

    # CIA pieces:
    cia_tab = rng.random((15, nwave)) * 1e-44
    cia_temps = np.linspace(60.0, 3000.0, 15)
    dcs = np.diff(cia_tab, axis=0) / np.diff(cia_temps)[:, None]

    # Alkali pieces:
    voigt_det = rng.random((nlayers, 2)) * 1e-3
    wn0 = np.array([16960.87, 16978.07])
    gf = np.array([0.65464, 1.30918])
    dwave = np.full(2, 1.0)
    i_wn0 = np.argmin(np.abs(wn0[:, None] - wn[None, :]), axis=1)

    def one_eval():
        ext = np.zeros((nlayers, nwave))
        ec.interp_ec(
            ext, etable, ttable, temp_profile, density, 0, nlayers,
        )
        cs = np.zeros((nlayers, nwave))
        sp.lin_interp_2D(
            cia_tab, cia_temps, dcs, temp_profile, cs, 0, nwave,
        )
        ext += cs
        alk = np.zeros((nlayers, nwave))
        _alkali.alkali_cross_section(
            press * pc.bar, wn, temp_profile, voigt_det, alk,
            30.0, 22.99, 0.071, 2.0, 4500.0, wn0, gf, dwave, i_wn0,
        )
        ext += alk * 1e10
        # Transit optical depth per impact parameter:
        ideep = np.array(np.tile(-1, nwave), dtype=np.intc)
        depth = np.zeros((nlayers, nwave))
        raypath = []
        r = radius
        for i in range(nlayers):
            path_i = np.sqrt(r[:i]**2 - r[i]**2)
            raypath.append(np.ediff1d(-path_i))
        for i in range(1, nlayers):
            depth[i] = t.optdepth(
                ext[:i + 1], raypath[i], 10.0, ideep, i,
            )
        ideep[ideep < 0] = nlayers - 1
        integ = np.exp(-depth) * r[:, None]
        h = np.ediff1d(r)
        spectrum = t.trapezoid2D(integ, h, ideep.astype(np.intc))
        return (r[0]**2 + 2 * spectrum) / (1.27 * pc.rsun)**2

    one_eval()  # warm-up
    start = time.perf_counter()
    for _ in range(n_eval):
        one_eval()
    elapsed = time.perf_counter() - start
    return n_eval / elapsed
