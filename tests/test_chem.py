"""Thermochemical-equilibrium chemistry tests.

The reference delegates to chemcat (not installed here, matching its
optional-dependency behavior); these tests validate the native network
(pyratbay_tpu/atmosphere/chem.py) against physics invariants instead of
golden files: literature thermodynamics, element conservation, mass
action, the Saha equation, and textbook solar-composition behavior.
"""
import numpy as np
import pytest
import jax

from conftest import requires_reference, REFERENCE_ROOT

from pyratbay_tpu.atmosphere import chem

R_GAS = 8.314462618


# Literature (JANAF / CODATA / Burcat): DfH298 [kJ/mol], S298 [J/mol/K]
LITERATURE = {
    'H2': (0.0, 130.68), 'O2': (0.0, 205.15), 'H2O': (-241.83, 188.84),
    'CH4': (-74.6, 186.25), 'CO': (-110.53, 197.66),
    'CO2': (-393.52, 213.79), 'N2': (0.0, 191.61),
    'NH3': (-45.9, 192.77), 'OH': (38.99, 183.74),
    'HCN': (135.1, 201.82), 'C2H2': (228.2, 200.93),
    'C2H4': (52.5, 219.32), 'C2H6': (-84.0, 229.16),
    'CH3': (146.5, 194.2), 'NO': (91.3, 210.76), 'NH2': (186.2, 194.9),
    'H': (217.998, 114.72), 'He': (0.0, 126.15), 'C': (716.68, 158.10),
    'N': (472.68, 153.30), 'O': (249.18, 161.06), 'Na': (107.5, 153.72),
    'K': (89.0, 160.34), 'S': (277.17, 167.83),
    'e-': (0.0, 20.87), 'H+': (1536.25, 108.95), 'H-': (139.03, 108.96),
    'Na+': (609.36, 148.0), 'K+': (514.26, 154.6),
    'TiO': (54.4, 233.4), 'SiO': (-100.4, 211.6),
    'H2S': (-20.5, 205.81), 'SO2': (-296.8, 248.2),
    # Metal / P / Cl network extension (JANAF):
    'Mg': (147.10, 148.65), 'Ca': (177.80, 154.89),
    'Al': (330.00, 164.55), 'Cr': (397.48, 174.31),
    'Mn': (283.30, 173.72), 'Ni': (430.10, 182.19),
    'P': (316.50, 163.20), 'Cl': (121.30, 165.19),
    'HCl': (-92.31, 186.90), 'Cl2': (0.0, 223.08),
    'NaCl': (-181.42, 229.81), 'KCl': (-214.57, 239.10),
    'MgH': (229.79, 193.20), 'AlH': (259.2, 187.88),
    'AlO': (66.94, 218.39), 'SiS': (112.5, 223.66),
    'CS': (280.33, 210.55), 'SO': (5.01, 221.94),
    'PO': (-27.5, 222.78), 'P2': (144.0, 218.13),
    'FeO': (251.04, 241.92),
    'PH3': (5.47, 210.24), 'SO3': (-395.77, 256.77),
    'SiH4': (34.31, 204.65), 'OCS': (-138.41, 231.57),
    'CS2': (116.94, 237.88),
}

# Species whose literature DfH298 carries >5 kJ/mol uncertainty (FeH,
# CrH: D0-derived; CaH: D0 ~1.70 eV; TiO2, SiH: structure/level data):
# pin only that thermo evaluates finite and monotone-S.
LOOSE_SPECIES = ['CaH', 'FeH', 'CrH', 'TiO2', 'SiH']


@pytest.mark.parametrize('species', sorted(LITERATURE))
def test_thermo_literature_pins(species):
    dfh_lit, s_lit = LITERATURE[species]
    h, s = chem.thermo_properties(species, 298.15)
    assert h[0] * R_GAS * 298.15 / 1000.0 == pytest.approx(dfh_lit, abs=3.0)
    assert s[0] * R_GAS == pytest.approx(s_lit, abs=2.0)


@pytest.mark.parametrize('species', LOOSE_SPECIES)
def test_thermo_loose_species_sane(species):
    temps = np.array([300.0, 1000.0, 3000.0])
    h, s = chem.thermo_properties(species, temps)
    assert np.all(np.isfinite(h)) and np.all(np.isfinite(s))
    assert np.all(np.diff(s) > 0)      # S(T) strictly increasing
    # Cp = d(H)/dT must stay above the translational floor 5R/2:
    hj = chem.thermo_properties(species, temps + 1.0)[0]
    cp = (hj * (temps + 1.0) - h * temps)
    assert np.all(cp > 2.49)


def test_pcl_network_equilibrium():
    """P/Cl/metal chemistry in a solar-composition H2 atmosphere:
    PH3 and HCl are the low-T reservoirs (Visscher et al. 2006),
    atomic Mg/Fe dominate their elements at high T."""
    press = np.full(4, 1.0)                    # bar
    temp = np.array([500.0, 500.0, 2500.0, 2500.0])
    species = (
        'H2 He H H2O CH4 CO PH3 PO P P2 HCl Cl NaCl KCl Na K '
        'Mg MgH Fe FeH'
    ).split()
    net = chem.Network(press, temp, species)
    vmr = net.thermochemical_equilibrium()
    idx = {s: i for i, s in enumerate(net.species)}
    # Low T: PH3 carries nearly all P; with solar Na+K > Cl, the
    # gas-only network locks Cl into the alkali chlorides:
    p_total = sum(
        vmr[0, idx[s]] * n for s in ('PH3', 'PO', 'P', 'P2')
        for n in [chem.parse_formula(s)[0].get('P', 0)]
    )
    cl_total = sum(
        vmr[0, idx[s]] for s in ('HCl', 'Cl', 'NaCl', 'KCl')
    )
    assert vmr[0, idx['PH3']] > 0.9 * p_total
    assert (
        vmr[0, idx['NaCl']] + vmr[0, idx['KCl']] > 0.9 * cl_total
    )
    # High T: atoms win over hydrides, HCl over the chlorides:
    assert vmr[2, idx['Mg']] > vmr[2, idx['MgH']]
    assert vmr[2, idx['P']] + vmr[2, idx['PO']] > vmr[2, idx['PH3']]
    assert vmr[2, idx['HCl']] > 10 * (
        vmr[2, idx['NaCl']] + vmr[2, idx['KCl']]
    )
    # Element conservation across the T jump (bulk H2/He fixed):
    assert vmr.shape == (4, len(net.species))
    assert np.all(np.isfinite(vmr)) and np.all(vmr >= 0)


@pytest.mark.parametrize('species', sorted(chem._NASA7))
def test_nasa7_range_continuity(species):
    tmid = chem._NASA7[species][0]
    h_lo, s_lo = chem.thermo_properties(species, tmid - 1e-9)
    h_hi, s_hi = chem.thermo_properties(species, tmid + 1e-9)
    assert h_lo[0] == pytest.approx(h_hi[0], rel=2e-3, abs=2e-3)
    assert s_lo[0] == pytest.approx(s_hi[0], rel=2e-3)


def test_parse_formula():
    assert chem.parse_formula('H2O') == ({'H': 2, 'O': 1}, 0)
    assert chem.parse_formula('C2H2') == ({'C': 2, 'H': 2}, 0)
    assert chem.parse_formula('e-') == ({}, -1)
    assert chem.parse_formula('Na+') == ({'Na': 1}, 1)
    assert chem.parse_formula('H-') == ({'H': 1}, -1)
    assert chem.parse_formula('TiO') == ({'Ti': 1, 'O': 1}, 0)
    with pytest.raises(ValueError):
        chem.parse_formula('Xq2')


def test_element_conservation_and_mass_action():
    species = 'H2O CH4 CO CO2 NH3 HCN N2 H2 H He'.split()
    nl = 16
    press = np.logspace(-8, 3, nl)
    temp = np.linspace(900.0, 2400.0, nl)
    net = chem.Network(press, temp, species, e_source='asplund_2009')
    vmr = net.thermochemical_equilibrium()
    assert vmr.shape == (nl, len(species))
    np.testing.assert_allclose(vmr.sum(axis=1), 1.0, rtol=1e-10)

    # Element ratios conserved at every layer:
    stoich = net.stoich_vals.astype(float)
    b = net.element_rel_abundance
    i_h = list(net.elements).index('H')
    for il in range(nl):
        eb = stoich.T @ vmr[il]
        np.testing.assert_allclose(
            eb / eb[i_h], b / b[i_h], rtol=1e-5,
        )

    # Mass action: CO + 3 H2 <-> CH4 + H2O must satisfy ln K from the
    # same Gibbs data (solver self-consistency):
    idx = {s: list(net.species).index(s) for s in net.species}
    for il in [0, nl // 2, nl - 1]:
        t_l = temp[il]
        g = {
            s: chem.gibbs_over_rt(s, t_l)[0]
            for s in ('CO', 'H2', 'CH4', 'H2O')
        }
        ln_k = -(g['CH4'] + g['H2O'] - g['CO'] - 3 * g['H2'])
        p, x = press[il], vmr[il]
        ln_q = (
            np.log(x[idx['CH4']] * p) + np.log(x[idx['H2O']] * p)
            - np.log(x[idx['CO']] * p) - 3 * np.log(x[idx['H2']] * p)
        )
        assert ln_q == pytest.approx(ln_k, abs=1e-6)


def test_saha_ionization():
    """Alkali ionization must reduce to the Saha equation."""
    species = 'H2 He H Na Na+ K K+ e-'.split()
    press = np.full(3, 1e-3)
    temp = np.array([2000.0, 2500.0, 3000.0])
    net = chem.Network(press, temp, species, e_source='asplund_2009')
    vmr = net.thermochemical_equilibrium()
    idx = {s: list(net.species).index(s) for s in net.species}

    # Charge neutrality:
    charge = vmr[:, idx['Na+']] + vmr[:, idx['K+']] - vmr[:, idx['e-']]
    np.testing.assert_allclose(charge, 0.0, atol=1e-9)

    # Saha for Na at 2500 K (ground-state g's; the network's excited
    # levels shift it by <2%):
    me, kb, h_pl = 9.1093837015e-31, 1.380649e-23, 6.62607015e-34
    t_k = 2500.0
    ie = 5.139076 * 1.602176634e-19
    saha = (2 * 1 / 2) * (2 * np.pi * me * kb * t_k / h_pl**2)**1.5 \
        * np.exp(-ie / (kb * t_k))
    il = 1
    ntot = press[il] * 1e5 / (kb * t_k)
    lhs = vmr[il, idx['Na+']] * vmr[il, idx['e-']] \
        / vmr[il, idx['Na']] * ntot
    assert lhs == pytest.approx(saha, rel=0.02)

    # K (IE 4.34 eV) ionizes before Na (5.14 eV):
    frac_na = vmr[:, idx['Na+']] / (vmr[:, idx['Na']] + vmr[:, idx['Na+']])
    frac_k = vmr[:, idx['K+']] / (vmr[:, idx['K']] + vmr[:, idx['K+']])
    assert np.all(frac_k > frac_na)
    assert np.all(np.diff(frac_na) > 0)


def test_solar_composition_trends():
    """Textbook solar-abundance behavior (e.g. Lodders 2002): CH4/CO
    crossover near 1100 K at 1 bar; NH3/N2; H2O mixing ratio ~5e-4."""
    species = 'H2O CH4 CO CO2 N2 NH3 H2 H He'.split()
    temp = np.array([600.0, 1000.0, 1200.0, 1600.0])
    net = chem.Network(np.ones(4), temp, species, e_source='asplund_2009')
    vmr = net.thermochemical_equilibrium()
    idx = {s: list(net.species).index(s) for s in net.species}
    # Low T: CH4 and NH3 dominate over CO and N2; high T: reversed.
    assert vmr[0, idx['CH4']] > 100 * vmr[0, idx['CO']]
    assert vmr[3, idx['CO']] > 100 * vmr[3, idx['CH4']]
    assert vmr[0, idx['NH3']] > vmr[0, idx['N2']]
    assert vmr[3, idx['N2']] > 100 * vmr[3, idx['NH3']]
    # H2-dominated with He/H2 ~ 0.17 x 2:
    assert vmr[1, idx['H2']] == pytest.approx(0.85, abs=0.03)
    assert vmr[0, idx['H2O']] == pytest.approx(8.4e-4, rel=0.15)


def test_metallicity_escale_ratio():
    species = 'H2O CH4 CO CO2 N2 NH3 H2 H He'.split()
    net = chem.Network(
        np.full(2, 0.1), np.full(2, 1400.0), species,
        e_source='asplund_2009',
    )
    idx = {s: list(net.species).index(s) for s in net.species}
    v_solar = net.thermochemical_equilibrium()

    # 10x metallicity boosts CO roughly 10x (O and C both scale):
    v_meta = net.thermochemical_equilibrium(metallicity=1.0)
    assert v_meta[0, idx['CO']] == pytest.approx(
        10 * v_solar[0, idx['CO']], rel=0.3,
    )
    net.metallicity = 0.0

    # e_scale on C only:
    v_c = net.thermochemical_equilibrium(e_scale={'C': 1.0})
    assert v_c[0, idx['CH4']] > 3 * v_solar[0, idx['CH4']]
    net.e_scale = {}

    # C/O > 1 suppresses H2O:
    v_co = net.thermochemical_equilibrium(e_ratio={'C_O': 1.5})
    assert v_co[0, idx['H2O']] < 0.01 * v_solar[0, idx['H2O']]
    assert v_co[0, idx['CH4']] > v_solar[0, idx['CH4']]

    # e_abundances dex override:
    net.e_ratio = {}
    v_ab = net.thermochemical_equilibrium(e_abundances={'C': 9.0})
    b = net.element_rel_abundance
    i_c = list(net.elements).index('C')
    assert b[i_c] == pytest.approx(10**(9.0 - 12.0))
    assert v_ab[0, idx['CH4']] > v_solar[0, idx['CH4']]


def test_network_drops_unknown_species():
    species = ['H2', 'He', 'H2O', 'C60']
    net = chem.Network(
        np.ones(2), np.full(2, 1000.0), species,
    )
    assert list(net.species) == ['H2', 'He', 'H2O']
    assert net.dropped_species == ['C60']


def test_chemistry_free_and_equilibrium():
    press = np.logspace(-6, 2, 9)
    temp = np.full(9, 1300.0)
    species = 'H2O CH4 CO H2 He'.split()
    q = [4e-4, 1e-6, 4e-4, 0.85, 0.15]
    network, out_species, vmr = chem.chemistry(
        'free', press, temp, species, q_uniform=q,
    )
    assert network is None
    np.testing.assert_allclose(vmr, np.tile(q, (9, 1)))

    network, out_species, vmr = chem.chemistry(
        'equilibrium', press, temp, species,
    )
    assert list(out_species) == species
    assert vmr.shape == (9, 5)
    np.testing.assert_allclose(vmr.sum(axis=1), 1.0, rtol=1e-9)


def test_jit_equilibrium_fn_grad_and_vmap():
    """The equilibrium solve must be jit/vmap-compatible (it lives
    inside the jitted retrieval forward; the reference host-calls
    chemcat per sample)."""
    species = 'H2O CH4 CO H2 He'.split()
    nl = 8
    press = np.logspace(-6, 2, nl)
    temp = np.full(nl, 1300.0)
    net = chem.Network(press, temp, species)
    fn = chem.jit_equilibrium_fn(net)
    v0 = jax.jit(fn)(temp)
    base = net.thermochemical_equilibrium()
    np.testing.assert_allclose(np.asarray(v0), base, rtol=1e-8)

    # vmap over a metallicity batch:
    import jax.numpy as jnp
    batch = jax.vmap(lambda m: fn(jnp.asarray(temp), m))(
        jnp.array([0.0, 0.5, 1.0]),
    )
    assert batch.shape == (3, nl, 5)
    i_h2o = list(net.species).index('H2O')
    assert float(batch[2, 4, i_h2o]) > 5 * float(batch[0, 4, i_h2o])


def test_model_equilibrium_integration(tmp_path):
    """chemistry=equilibrium end-to-end: Model setup, spectrum run,
    jitted forward consistency, [M/H] retrieval parameter, hybrid."""
    import pyratbay_tpu as pb
    from pyratbay_tpu.retrieval.forward import build_forward

    cfg = tmp_path / 'eq.cfg'
    cfg.write_text("""[pyrat]
runmode = spectrum
rt_path = transit
wl_low = 1.0 um
wl_high = 2.0 um
resolution = 2000.0
nlayers = 24
ptop = 1e-8 bar
pbottom = 100 bar
tmodel = isothermal
tpars = 1400.0
chemistry = equilibrium
species = H2 He H H2O CH4 CO CO2 Na K
vmr_vars = [M/H] 0.0
rayleigh = rayleigh_H2
alkali = sodium_vdw potassium_vdw
rplanet = 1.0 rjup
mplanet = 0.6 mjup
rstar = 1.0 rsun
refpressure = 0.1 bar
radmodel = hydro_m
""")
    model = pb.Model(str(cfg))
    assert model.chem_model is not None
    i_h2o = model.species.index('H2O')
    assert model.base_vmr[12, i_h2o] == pytest.approx(4e-4, rel=0.4)

    res = model.run()
    sp = np.asarray(res['spectrum'])
    assert np.all(np.isfinite(sp)) and np.all(sp > 0)

    fwd = jax.jit(build_forward(model))
    np.testing.assert_allclose(
        np.asarray(fwd()['spectrum']), sp, rtol=1e-6,
    )

    # Metallicity parameter raises the H2O feature amplitude:
    v1 = np.asarray(model.eval_vmr([np.array([1.0])]))
    assert v1[12, i_h2o] == pytest.approx(
        10 * model.base_vmr[12, i_h2o], rel=0.3,
    )

    # Hybrid free-VMR override on top of equilibrium, element-capped:
    cfg2 = tmp_path / 'eq2.cfg'
    cfg2.write_text(cfg.read_text().replace(
        'vmr_vars = [M/H] 0.0',
        'vmr_vars = [M/H] 0.0\n    log_H2O -5.0\n    C/O 0.9',
    ))
    m2 = pb.Model(str(cfg2))
    v2 = np.asarray(m2.eval_vmr())
    assert v2[12, m2.species.index('H2O')] == pytest.approx(1e-5, rel=1e-6)
    # Cap: requesting more H2O than available O clips to the O budget:
    big = [np.array([0.0]), np.array([0.0]), np.array([0.9])]
    v3 = np.asarray(m2.eval_vmr(big))
    assert v3[12, m2.species.index('H2O')] < 2e-3


@requires_reference
def test_tea_profile_vs_chemcat_golden():
    """Native Gibbs network vs the reference's stored chemcat TEA
    profile (expected_tea_profile.npz): bulk species exact, traces to
    <= 1% after the g0 chemcat-parity calibration (chem.py
    _G0_CALIBRATION; fitted on THIS golden, validated held-out by
    test_tea_sub_solar_vs_chemcat_golden)."""
    from pyratbay_tpu import driver
    model = driver.run(
        REFERENCE_ROOT + 'tests/configs/atmosphere_equilibrium_test.cfg',
        root=REFERENCE_ROOT, with_log=False,
    )
    gold = np.load(
        REFERENCE_ROOT + 'tests/expected/expected_tea_profile.npz'
    )['arr_0']
    vmr = model.base_vmr
    assert vmr.shape == gold.shape
    # Bulk species (H2, He) match to float64 solver precision:
    np.testing.assert_allclose(vmr[:, :2], gold[:, :2], rtol=1e-4)
    # Trace species (retrieval-relevant absorbers):
    strong = gold > 1e-10
    dev = np.abs(vmr[strong] / gold[strong] - 1)
    assert dev.max() < 0.01
    assert np.median(dev) < 5e-4


@requires_reference
def test_tea_sub_solar_vs_chemcat_golden(tmp_path):
    """HELD-OUT chemcat validation: the [M/H] = -1 variant
    (expected_tea_sub_solar_profile.npz) was never used to fit the
    _G0_CALIBRATION offsets, so <= 1% here shows the calibration
    captures thermo differences, not one profile's quirks."""
    from pyratbay_tpu import driver
    base = open(
        REFERENCE_ROOT + 'tests/configs/atmosphere_equilibrium_test.cfg'
    ).read()
    cfg = tmp_path / 'sub_solar.cfg'
    cfg.write_text(base + '\nvmr_vars = [M/H] -1.0\n')
    model = driver.run(str(cfg), root=REFERENCE_ROOT, with_log=False)
    gold = np.load(
        REFERENCE_ROOT
        + 'tests/expected/expected_tea_sub_solar_profile.npz'
    )['arr_0']
    vmr = np.asarray(model.eval_vmr())
    assert vmr.shape == gold.shape
    np.testing.assert_allclose(vmr[:, :2], gold[:, :2], rtol=1e-4)
    strong = gold > 1e-10
    dev = np.abs(vmr[strong] / gold[strong] - 1)
    assert dev.max() < 0.01
    assert np.median(dev) < 5e-4


@requires_reference
def test_f32_equilibrium_mass_balance():
    """The float32 (device retrieval path) solver preserves element
    ratios at low pressure (He/H to < 1%)."""
    import jax.numpy as jnp
    species = 'H2 He Na K H2O CH4 CO CO2 NH3 HCN N2'.split()
    press = np.array([1.26e-5, 1e-2, 10.0])
    temp = np.array([1046.94, 1400.0, 2400.0])
    net = chem.Network(press, temp, species)
    fn = chem.jit_equilibrium_fn(net)
    vmr = np.asarray(fn(jnp.asarray(temp, jnp.float32)))
    h_tot = (
        2 * vmr[:, 0] + 2 * vmr[:, 4] + 4 * vmr[:, 5]
        + 3 * vmr[:, 8] + vmr[:, 9]
    )
    he_h = vmr[:, 1] / h_tot
    expected = 10.0 ** (net._solar_dex[1] - 12.0)
    np.testing.assert_allclose(he_h, expected, rtol=0.01)


def test_thermo_uncertainty_table_consistent():
    """The documented uncertainty table (chem.THERMO_UNCERTAINTY) must
    quote exactly the formation enthalpies the solver uses, so the
    stated provenance cannot drift from the data."""
    for name, (dfh, unc, source) in chem.THERMO_UNCERTAINTY.items():
        if name in chem._DIATOMICS:
            used = chem._DIATOMICS[name][0]
        elif name in chem._POLYATOMICS:
            used = chem._POLYATOMICS[name][0]
        else:
            raise AssertionError(f'{name} has no thermo entry')
        assert used == dfh, (name, used, dfh)
        assert unc > 0 and source


def test_thermo_uncertainty_vmr_impact():
    """Quantify the equilibrium-VMR impact of the residual FeH/CrH/
    CaH enthalpy uncertainty: a +-u shift moves the trace VMR by
    ~exp(u/RT) (the documented guidance for abundance science on
    these species)."""
    press = np.logspace(-4, 1, 12)
    temp = np.full(12, 2000.0)
    species = ['H2', 'H', 'He', 'Fe', 'FeH', 'Ca', 'CaH', 'Cr', 'CrH']

    def vmrs(shift_kj):
        orig = dict(chem._DIATOMICS)
        try:
            for sp in ('FeH', 'CaH', 'CrH'):
                vals = list(chem._DIATOMICS[sp])
                vals[0] = vals[0] + shift_kj
                chem._DIATOMICS[sp] = tuple(vals)
            net = chem.Network(press, temp, species)
            return np.asarray(net.thermochemical_equilibrium())
        finally:
            chem._DIATOMICS.clear()
            chem._DIATOMICS.update(orig)

    base = vmrs(0.0)
    hi = vmrs(+10.0)
    names = list(np.asarray(
        chem.Network(press, temp, species).species))
    r_gas_kj = 8.31446e-3
    expected = np.exp(-10.0 / (r_gas_kj * 2000.0))   # ~0.548
    for sp in ('FeH', 'CaH', 'CrH'):
        i = names.index(sp)
        ratio = hi[:, i] / base[:, i]
        # Within 20% of the analytic factor (the metal reservoir
        # shifts slightly too):
        assert np.all(np.abs(ratio / expected - 1) < 0.2), (sp, ratio)
