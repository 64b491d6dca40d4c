"""DirectLBL (the plain XLA line-by-line engine) against an exact
float64 Voigt sum (scipy.special.wofz) over a synthetic line list:
the asymptotic wing series, single- and multi-species cross
sections, the jit/vmap extinction function and tabulate()."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.special as ss

import pyratbay_tpu.constants as pc
from pyratbay_tpu.benchmark import synthetic_lines
from pyratbay_tpu.opacity.lbl_tpu import DirectLBL, _wing_series

VMR = np.array([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7])


def np_cross_section(lines, wn, temp, dens, pf):
    """sigma [nspec, nwave] (cm2/molec): exact Voigt profiles within
    the cutoff, strengths from the HITRAN-style Boltzmann terms."""
    iso = lines.isoid
    mass = lines.iso_mass[iso]
    imol = lines.iso_atm_index[iso]
    coll = lines.mol_radius[imol][:, None] + lines.mol_radius[None, :]
    flor = np.sqrt(2 * pc.KB_KERNEL * temp / np.pi / pc.AMU_KERNEL) \
        / pc.LS_KERNEL
    alphal = flor * np.sum(
        dens[None, :] * coll**2
        * np.sqrt(1 / mass[:, None] + 1 / lines.mol_mass[None, :]),
        axis=1,
    )
    sigma_d = np.sqrt(2 * pc.KB_KERNEL * temp / (pc.AMU_KERNEL * mass)) \
        / pc.LS_KERNEL * lines.lwn
    strength = (
        pc.SIGCTE * lines.iso_ratio[iso] * lines.gf
        * np.exp(-pc.EXPCTE * lines.elow / temp)
        * -np.expm1(-pc.EXPCTE * lines.lwn / temp) / pf[iso]
    )
    out = np.zeros((lines.nspec, len(wn)))
    spec = lines.iso_spec_index[iso]
    for ln in range(len(lines.lwn)):
        dx = wn - lines.lwn[ln]
        near = np.abs(dx) <= lines.cutoff
        z = (dx[near] + 1j * alphal[ln]) / sigma_d[ln]
        out[spec[ln], near] += strength[ln] * ss.wofz(z).real / (
            sigma_d[ln] * np.sqrt(np.pi))
    return out


def _cells(temps, press):
    temps = np.asarray(temps, float)
    dens = VMR[None, :] * (
        np.asarray(press)[:, None] * pc.bar / (pc.k * temps[:, None]))
    return temps, dens


def _assert_strong_close(got, ref, rtol):
    strong = ref > 1e-4 * ref.max()
    np.testing.assert_allclose(got[strong], ref[strong], rtol=rtol)


@pytest.fixture(scope='module')
def lines():
    return synthetic_lines(nlines=1500, seed=3)


def test_wing_series_matches_wofz():
    """Re w(z) = y u S(u, a) / sqrt(pi) beyond |z| = 7, to 2e-6."""
    x, y = np.meshgrid(np.linspace(-60, 60, 241),
                       np.geomspace(1e-4, 50, 60))
    keep = x**2 + y**2 >= 49.0
    x, y = x[keep], y[keep]
    u = 1.0 / (x**2 + y**2)
    approx = y * u * np.asarray(_wing_series(u, x**2 * u)) / np.sqrt(np.pi)
    exact = ss.wofz(x + 1j * y).real
    np.testing.assert_allclose(approx, exact, rtol=2e-6)


@pytest.mark.parametrize('temp, press', [
    (700.0, 1e-4), (1500.0, 0.1), (2900.0, 10.0),
])
def test_cross_section_matches_exact_voigt(lines, temp, press):
    direct = DirectLBL(lines, tile=128)
    temps, dens = _cells([temp], [press])
    pf = lines.iso_pf(temps).T
    got = np.asarray(direct._cross_section_batch(
        direct.tables(), jnp.asarray(temps), jnp.asarray(dens),
        jnp.asarray(pf),
    ))[0, 0]
    ref = np_cross_section(lines, direct.wn, temp, dens[0], pf[0])[0]
    _assert_strong_close(got, ref, rtol=1e-5)


def test_multispecies_matches_exact_voigt():
    """nspec > 1 splits the sum per species."""
    lines = synthetic_lines(nlines=1200, seed=4)
    lines.iso_spec_index = np.array([0, 0, 1, 1])
    lines.iso_atm_index = np.array([5, 5, 6, 6])
    lines.nspec = 2
    direct = DirectLBL(lines, tile=128)
    temps, dens = _cells([1800.0], [1.0])
    pf = lines.iso_pf(temps).T
    got = np.asarray(direct._cross_section_batch(
        direct.tables(), jnp.asarray(temps), jnp.asarray(dens),
        jnp.asarray(pf),
    ))[0]
    ref = np_cross_section(lines, direct.wn, 1800.0, dens[0], pf[0])
    assert got.shape == (2, direct.nwave)
    for s in range(2):
        _assert_strong_close(got[s], ref[s], rtol=1e-5)


def test_extinction_fn_under_vmap(lines):
    """The retrieval forward's batching: vmap over chains of the
    jit-safe extinction (partition functions from the engine's own
    dense grid) == sum of exact cross sections x density."""
    direct = DirectLBL(lines, tile=128)
    ec_fn = direct.extinction_fn()
    press = np.array([1e-3, 1.0])
    t2 = np.array([[900.0, 1300.0], [2000.0, 2400.0]])
    dens2 = np.stack([_cells(t, press)[1] for t in t2])
    got = np.asarray(jax.jit(jax.vmap(ec_fn))(
        jnp.asarray(t2), jnp.asarray(dens2)))
    imol = lines.iso_atm_index[0]
    for c in range(2):
        for layer in range(2):
            temp = t2[c, layer]
            pf = lines.iso_pf(np.array([temp]))[:, 0]
            ref = np_cross_section(
                lines, direct.wn, temp, dens2[c, layer], pf)[0] \
                * dens2[c, layer, imol]
            _assert_strong_close(got[c, layer], ref, rtol=2e-5)


def test_tabulate_matches_exact_voigt(lines):
    """tabulate() runs its float32 sweep; 2e-4 is the f32 budget."""
    direct = DirectLBL(lines, tile=128)
    press = np.array([1e-4, 1e-1, 10.0])
    tab_t = np.array([600.0, 2200.0])
    table = direct.tabulate(tab_t, press, np.tile(VMR, (3, 1)), block=4)
    assert table.shape == (2, 3, direct.nwave)
    for i, temp in enumerate(tab_t):
        temps, dens = _cells([temp] * 3, press)
        pf = lines.iso_pf(temps).T
        for layer in range(3):
            ref = np_cross_section(
                lines, direct.wn, temp, dens[layer], pf[layer])[0]
            _assert_strong_close(table[i, layer], ref, rtol=2e-4)
