"""Direct-evaluation LBL engine (device fast path) accuracy tests."""
import configparser

import numpy as np
import pytest
import scipy.special as ss

from conftest import requires_reference, REFERENCE_ROOT

import pyratbay_tpu.constants as pc
from pyratbay_tpu.model import Model
from pyratbay_tpu.opacity.tli import make_tli
from pyratbay_tpu.opacity.lbl_tpu import DirectLBL

MOCK_PAR = REFERENCE_ROOT + 'tests/inputs/Mock_HITRAN_H2O_1.00-1.01um.par'
BASE_CFG = REFERENCE_ROOT + 'tests/configs/spectrum_transmission_test.cfg'


@pytest.fixture(scope='module')
def lbl_model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dlbl')
    tli = str(tmp / 'h2o.tli')
    make_tli([MOCK_PAR], ['tips'], ['hitran'], tli, 1.0, 1.01, 'um')
    ini = configparser.ConfigParser()
    ini.optionxform = str
    ini.read(BASE_CFG)
    for key in ('sampled_cross_sec', 'continuum_cross_sec', 'alkali',
                'clouds'):
        ini.remove_option('pyrat', key)
    ini.set('pyrat', 'tlifile', tli)
    ini.set('pyrat', 'wl_low', '1.0 um')
    ini.set('pyrat', 'wl_high', '1.01 um')
    cfg = str(tmp / 'lbl.cfg')
    with open(cfg, 'w') as f:
        ini.write(f)
    return Model(cfg, root=REFERENCE_ROOT)


@requires_reference
def test_direct_lbl_vs_exact(lbl_model):
    """DirectLBL matches an exact wofz-based computation to ~1e-6."""
    model = lbl_model
    lbl = model.opacity_models[0][1]
    direct = DirectLBL(lbl)

    temp = 1400.0
    dens = np.asarray(model.base_vmr[25]) * (
        model.press[25] * pc.bar / (pc.k * temp)
    )
    cs = np.asarray(direct.cross_section(temp, dens))[0]

    pf = lbl.iso_pf(np.array([temp]))[:, 0]
    alphal, alphad = lbl._layer_widths(temp, dens)
    k = (
        pc.SIGCTE * lbl.iso_ratio[lbl.isoid] * lbl.gf
        * np.exp(-pc.EXPCTE * lbl.elow / temp)
        * -np.expm1(-pc.EXPCTE * lbl.lwn / temp) / pf[lbl.isoid]
    )
    cs_exact = np.zeros(model.nwave)
    for ln in range(lbl.ntransitions):
        iso = lbl.isoid[ln]
        a_d = alphad[iso] * lbl.lwn[ln]
        sigma = a_d / np.sqrt(np.log(2))
        dx = model.wn - lbl.lwn[ln]
        prof = ss.wofz((dx + 1j * alphal[iso]) / sigma).real / (
            sigma * np.sqrt(np.pi))
        prof[np.abs(dx) > lbl.cutoff] = 0.0
        cs_exact += k[ln] * prof

    strong = cs_exact > 1e-4 * cs_exact.max()
    np.testing.assert_allclose(cs[strong], cs_exact[strong], rtol=1e-5)


@requires_reference
def test_direct_lbl_tabulate(lbl_model):
    """tabulate() produces a finite, physically-ordered table."""
    model = lbl_model
    lbl = model.opacity_models[0][1]
    direct = DirectLBL(lbl)
    temps = np.array([500.0, 1500.0, 2500.0])
    table = direct.tabulate(temps, model.press[::10], model.base_vmr[::10])
    assert table.shape == (3, len(model.press[::10]), model.nwave)
    assert np.all(np.isfinite(table))
    assert table.max() > 0
    # Higher pressure -> broader lines -> smaller peak, larger wings:
    peak_low_p = table[1, 0].max()
    peak_high_p = table[1, -1].max()
    assert peak_low_p > peak_high_p


@requires_reference
def test_lbl_in_jitted_forward(lbl_model):
    """The jitted retrieval forward accepts live LBL opacity via
    DirectLBL and matches the parity-engine spectrum within the
    profile-grid quantization."""
    import jax
    from pyratbay_tpu.retrieval.forward import build_forward

    model = lbl_model
    forward = jax.jit(build_forward(model))
    out = forward()
    spec_direct = np.asarray(out['spectrum'])

    spec_parity = np.asarray(model.run()['spectrum'])
    assert np.all(np.isfinite(spec_direct))
    # Direct vs profile-grid engines differ only by the grid
    # quantization (few % of the spectral modulation):
    mod = spec_parity.max() - spec_parity.min()
    np.testing.assert_allclose(
        spec_direct, spec_parity, atol=0.05 * mod,
    )


@requires_reference
def test_direct_lbl_vs_parity_engine(lbl_model):
    """Direct evaluation agrees with the profile-grid engine within
    its quantization error (~few %)."""
    model = lbl_model
    lbl = model.opacity_models[0][1]
    direct = DirectLBL(lbl)
    temp_prof = np.full(model.nlayers, 1200.0)
    dens = np.asarray(model.base_vmr) * (
        model.press[:, None] * pc.bar / (pc.k * 1200.0)
    )
    layer = 30
    cs_direct = np.asarray(
        direct.cross_section(1200.0, dens[layer]))[0]
    cs_parity = lbl.cross_section(temp_prof, dens, layer=layer)[layer]
    strong = cs_parity > 0.05 * cs_parity.max()
    ratio = cs_direct[strong] / cs_parity[strong]
    assert np.median(np.abs(ratio - 1.0)) < 0.05
