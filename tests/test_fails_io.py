"""Pinned error messages for the areas test_fails.py's config matrix
does not reach: io readers, observation wiring, TLI machinery,
retrieval driver/sampler, and the radeq loop (reference-style exact
message pinning, tests/test_fails.py there)."""
import os
import re

import numpy as np
import pytest

from pyratbay_tpu.io import io as pio


# ---------------------------------------------------------------------
# io.read_atm

def _write(path, text):
    with open(path, 'w') as f:
        f.write(text)
    return str(path)


def test_read_atm_missing_pressure_header(tmp_path):
    fname = _write(tmp_path / 'bad.atm',
                   '@TEMPERATURE\nkelvin\n@DATA\n1.0 100.0\n')
    with pytest.raises(
            ValueError,
            match=re.escape(
                "Atmospheric file does not have '@PRESSURE' header")):
        pio.read_atm(fname)


def test_read_atm_missing_temperature_header(tmp_path):
    fname = _write(tmp_path / 'bad.atm',
                   '@PRESSURE\nbar\n@DATA\n1.0 100.0\n')
    with pytest.raises(
            ValueError,
            match=re.escape(
                "Atmospheric file does not have '@TEMPERATURE' header")):
        pio.read_atm(fname)


def test_read_atm_unexpected_line(tmp_path):
    fname = _write(tmp_path / 'bad.atm',
                   '@PRESSURE bar\n@WHATEVER\n')
    with pytest.raises(
            ValueError,
            match='Atmosphere file has unexpected line'):
        pio.read_atm(fname)


def test_read_atm_inconsistent_columns(tmp_path):
    fname = _write(
        tmp_path / 'bad.atm',
        '@PRESSURE\nbar\n@TEMPERATURE\nkelvin\n'
        '@SPECIES\nH2 He\n@DATA\n1.0 100.0 0.9\n1.0 100.0 0.9\n',
    )
    with pytest.raises(
            ValueError,
            match=re.escape(
                'Inconsistent number of columns (3) in @DATA')):
        pio.read_atm(fname)


def test_write_spectrum_invalid_type(tmp_path):
    with pytest.raises(
            ValueError,
            match=re.escape(
                "Input 'type' argument must be 'transit', 'eclipse', "
                "'emission', 'f_lambda', or 'filter'")):
        pio.write_spectrum(
            np.array([1.0, 1.1]), np.array([1.0, 1.0]),
            str(tmp_path / 's.dat'), 'nope',
        )


def test_write_opacity_species_must_be_string(tmp_path):
    with pytest.raises(ValueError,
                       match=re.escape("'species' input must be a string")):
        pio.write_opacity(
            str(tmp_path / 'op.npz'), ['H2O'], np.ones(2), np.ones(2),
            np.ones(2), np.ones((2, 2, 2)),
        )


def test_species_properties_unknown_species():
    with pytest.raises(
            ValueError,
            match='not in the species database'):
        pio.species_properties(['H2', 'NotAMolecule'])


# ---------------------------------------------------------------------
# Observation wiring

def test_observation_uncert_length_mismatch(flagship_obs):
    import copy
    from pyratbay_tpu.observation import Observation
    cfg = copy.deepcopy(flagship_obs.cfg)
    cfg.data = np.array([1.0, 2.0, 3.0])
    cfg.uncert = np.array([0.1, 0.1])
    with pytest.raises(
            ValueError,
            match=re.escape(
                'Number of data uncertainty values (2) does not match '
                'the number of data points (3)')):
        Observation(cfg, np.linspace(5000.0, 6000.0, 50))


def test_observation_offset_unknown_instrument(flagship_obs):
    import copy
    from pyratbay_tpu.observation import Observation
    cfg = copy.deepcopy(flagship_obs.cfg)
    cfg.offset_inst = 'offset_NOPE 0.0'
    with pytest.raises(
            ValueError,
            match=re.escape(
                "Invalid instrumental offset parameter "
                "'offset_NOPE'. There is no instrument matching the "
                "name 'NOPE'")):
        Observation(cfg, flagship_obs.wn)


def test_observation_error_param_bad_prefix(flagship_obs):
    import copy
    from pyratbay_tpu.observation import Observation
    cfg = copy.deepcopy(flagship_obs.cfg)
    cfg.uncert_scaling = 'err_wrong_tophat 0.0'
    with pytest.raises(
            ValueError,
            match=re.escape(
                "Invalid error scaling parameter 'err_wrong_tophat'. "
                "Valid options begin with: ['err_scale_', "
                "'err_quad_']")):
        Observation(cfg, flagship_obs.wn)


def test_observation_error_param_unknown_instrument(flagship_obs):
    import copy
    from pyratbay_tpu.observation import Observation
    cfg = copy.deepcopy(flagship_obs.cfg)
    cfg.uncert_scaling = 'err_scale_NOPE 0.0'
    with pytest.raises(
            ValueError,
            match=re.escape(
                "Invalid retrieval parameter 'err_scale_NOPE'. There "
                "is no instrument matching the name 'NOPE'")):
        Observation(cfg, flagship_obs.wn)


@pytest.fixture(scope='module')
def flagship_obs(tmp_path_factory):
    from pyratbay_tpu.benchmark import make_flagship
    tmp = str(tmp_path_factory.mktemp('failsio') / 'flag')
    model, obs, ret, fwd, p0 = make_flagship(
        tmp, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=2.0,
    )
    obs.cfg = model.cfg
    obs.wn = np.asarray(model.wn)
    return obs


# ---------------------------------------------------------------------
# TLI machinery

def test_make_tli_count_mismatch(tmp_path):
    from pyratbay_tpu.opacity.tli import make_tli
    a = _write(tmp_path / 'a.par', '')
    b = _write(tmp_path / 'b.par', '')
    with pytest.raises(
            ValueError,
            match=re.escape(
                'The number of line-transition files (2) does not '
                'match the number of partition-function files (3) or '
                'database types (2)')):
        make_tli(
            [a, b], ['tips', 'tips', 'tips'], ['hitran', 'hitran'],
            str(tmp_path / 'o.tli'), 1.0, 2.0, 'um',
        )


def test_read_tli_bad_version(tmp_path):
    from pyratbay_tpu.opacity.tli import read_tli
    import struct
    fname = str(tmp_path / 'bad.tli')
    with open(fname, 'wb') as f:
        import sys
        f.write(sys.byteorder[0].encode())
        f.write(struct.pack('3h', 9, 0, 0))
    with pytest.raises(
            ValueError,
            match='Incompatible TLI version; must be Lineread 6.1-6.5'):
        read_tli(fname)


def test_read_tli_bad_endianness(tmp_path):
    from pyratbay_tpu.opacity.tli import read_tli
    import sys
    fname = str(tmp_path / 'bad.tli')
    other = 'b' if sys.byteorder[0] == 'l' else 'l'
    with open(fname, 'wb') as f:
        f.write(other.encode())
    with pytest.raises(
            ValueError, match='Incompatible endianness between TLI'):
        read_tli(fname)


def test_linelist_unknown_dbtype():
    from pyratbay_tpu.opacity.linelists import get_linelist_reader
    with pytest.raises(
            ValueError,
            match="Unknown database type 'nodb', select from"):
        get_linelist_reader('nodb')


# ---------------------------------------------------------------------
# Retrieval driver / sampler / radeq

def test_sampler_needs_nchains():
    from pyratbay_tpu.retrieval import sample_demc
    with pytest.raises(
            ValueError,
            match='nchains needed with a single init vector'):
        sample_demc(lambda p: 0.0, np.zeros(3), nsamples=10)


def test_retrieval_requires_data(flagship_obs):
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.driver import run_retrieval
    import tempfile
    tmp = tempfile.mkdtemp() + '/f2'
    model, obs, ret, fwd, p0 = make_flagship(
        tmp, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=2.0,
    )
    model.cfg.data = None
    model.cfg.filters = None
    with pytest.raises(
            ValueError,
            match='Undefined observed data/filters, required for '
                  'retrieval'):
        run_retrieval(model)


def test_radeq_requires_two_stream(flagship_obs):
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.spectrum.radeq import radiative_equilibrium
    import tempfile
    tmp = tempfile.mkdtemp() + '/f3'
    model, obs, ret, fwd, p0 = make_flagship(
        tmp, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=2.0,
    )
    with pytest.raises(
            ValueError,
            match="Radiative equilibrium requires rt_path = "
                  "'emission_two_stream'"):
        radiative_equilibrium(model, nsamples=2)


def test_radeq_scan_rejects_convection():
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.spectrum.radeq import radiative_equilibrium
    import tempfile
    tmp = tempfile.mkdtemp() + '/f4'
    model, obs, ret, fwd, p0 = make_flagship(
        tmp, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=2.0,
    )
    model.rt_path = 'emission_two_stream'
    with pytest.raises(
            ValueError,
            match=re.escape(
                'use_scan=True does not support convection (the '
                'convective-flux redo is data-dependent control '
                'flow)')):
        radiative_equilibrium(
            model, nsamples=2, convection=True, use_scan=True,
        )


def test_gauss_filter_small_grid_message():
    import numpy as np
    from pyratbay_tpu.spectrum.radeq import _gauss_filter_reflect
    with pytest.raises(
            ValueError,
            match=re.escape(
                'gaussian smoothing needs more than 8 layers (got 5); '
                'use use_scan=False for very small layer grids')):
        _gauss_filter_reflect(np.ones(5), 1.0, 8, np)


# ---------------------------------------------------------------------
# Wavenumber grids, chemistry formulas, line-sample tables

def test_grid_undefined_low_boundary():
    from pyratbay_tpu.ops.grids import wavenumber_grid
    with pytest.raises(
            ValueError, match='Undefined low wavenumber boundary'):
        wavenumber_grid(wnhigh=9000.0, wnstep=1.0)


def test_grid_undefined_high_boundary():
    from pyratbay_tpu.ops.grids import wavenumber_grid
    with pytest.raises(
            ValueError, match='Undefined high wavenumber boundary'):
        wavenumber_grid(wnlow=5000.0, wnstep=1.0)


def test_grid_inverted_boundaries():
    from pyratbay_tpu.ops.grids import wavenumber_grid
    with pytest.raises(
            ValueError,
            match=re.escape(
                'Wavenumber low boundary (9000.0 cm-1) must be larger '
                'than the high boundary (5000.0 cm-1)')):
        wavenumber_grid(wnlow=9000.0, wnhigh=5000.0, wnstep=1.0)


def test_grid_undefined_sampling():
    from pyratbay_tpu.ops.grids import wavenumber_grid
    with pytest.raises(
            ValueError,
            match='Undefined spectral sampling rate: set resolution, '
                  'wnstep, or wlstep'):
        wavenumber_grid(wnlow=5000.0, wnhigh=9000.0)


def test_chem_bad_formula():
    from pyratbay_tpu.atmosphere.chem import parse_formula
    with pytest.raises(
            ValueError,
            match=re.escape("Cannot parse species formula 'H2O@'")):
        parse_formula('H2O@')


def test_chem_unknown_element():
    from pyratbay_tpu.atmosphere.chem import parse_formula
    with pytest.raises(
            ValueError,
            match=re.escape("Unknown element 'Xx' in 'XxO'")):
        parse_formula('XxO')


def test_chem_no_thermo_data():
    from pyratbay_tpu.atmosphere.chem import thermo_properties
    with pytest.raises(
            ValueError,
            match=re.escape(
                "No thermodynamic data for species 'Kr2O7'")):
        thermo_properties('Kr2O7', np.array([1000.0]))


def test_line_sample_bad_isotope_entry(tmp_path, flagship_obs):
    from pyratbay_tpu.opacity.line_sample import LineSample
    with pytest.raises(
            ValueError,
            match=re.escape(
                "Invalid isotope_ratios entry (expected "
                "'<file_label> <label> <value>'): 'only two'")):
        LineSample(['whatever.npz'], isotope_ratios='only two')


def test_alkali_unknown_model():
    from pyratbay_tpu.opacity import get_alkali_model
    with pytest.raises(
            ValueError,
            match="Invalid alkali model 'cesium_vdw', select from"):
        get_alkali_model(
            'cesium_vdw', np.logspace(-6, 2, 5),
            np.linspace(5000.0, 6000.0, 50),
        )


def test_ensemble_unsupported_fallback(flagship_obs):
    # Not an error message, but the documented contract: two-stream
    # configurations (layer recurrences) fall back to vmap, flagged
    # as such; plane-parallel emission runs the batched hot path.
    from pyratbay_tpu.benchmark import make_flagship
    from pyratbay_tpu.retrieval.batched import build_forward_batched
    import tempfile
    tmp = tempfile.mkdtemp() + '/f5'
    model, obs, ret, fwd, p0 = make_flagship(
        tmp, nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=2.0,
    )
    model.rt_path = 'emission_two_stream'
    fb = build_forward_batched(model, obs, ret)
    assert fb.is_fallback
    model.rt_path = 'emission'
    fb = build_forward_batched(model, obs, ret)
    assert not fb.is_fallback


def test_pressure_bad_units():
    from pyratbay_tpu.atmosphere.profiles import pressure
    with pytest.raises(ValueError):
        pressure('1e-6 parsec', '1e2 bar', 10)


def test_cia_missing_file():
    from pyratbay_tpu.opacity.cia import CIA
    with pytest.raises((OSError, FileNotFoundError, ValueError)):
        CIA('/nonexistent/cia_file.dat')


def test_read_opacity_single_species(tmp_path):
    import numpy as np
    fname = str(tmp_path / 'two_species.npz')
    np.savez(
        fname, species=np.array(['H2O', 'CH4']),
        temperature=np.ones(2), pressure=np.ones(2),
        wavenumber=np.ones(2), opacity=np.ones((2, 2, 2, 2)),
    )
    with pytest.raises(
            ValueError,
            match='Opacity files must contain a single species'):
        pio.read_opacity(fname, 'arrays')


def test_read_opacity_h5_without_h5py(tmp_path, monkeypatch):
    """A petitRADTRANS table without h5py installed names the package."""
    import sys
    from pyratbay_tpu.io import io as pio
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match="'h5py'"):
        pio.read_opacity(str(tmp_path / 'H2O_petitRADTRANS.h5'))
