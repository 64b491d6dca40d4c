"""High-level forward model: configuration -> jittable spectrum pipeline.

This is the functional redesign of the reference's Pyrat god-object
(pyratbay/pyrat/pyrat_obj.py): setup reads files and assembles static
tables once; the forward evaluation
    (temperature, vmr, radius, model parameters) -> spectrum
is a pure function suitable for jax.jit / vmap (retrieval ensembles) /
shard_map (multi-chip).
"""
import os

import numpy as np
import scipy.constants as sc
import jax
import jax.numpy as jnp

from . import constants as pc
from .config import parser as cfg_parser
from .io import io as pio
from .ops.grids import wavenumber_grid, WavenumberGrid
from .ops.planck import blackbody_wn
from .atmosphere import (
    chem, geometry, hydro, profiles, vmr as vmr_models,
)
from .opacity import (
    CIA, Deck, CCSgray, HydrogenIon, Lecavelier, LineSample, Rayleigh,
    get_alkali_model,
)
from .spectrum import rt
from .spectrum.starspec import bbflux, read_kurucz
from .spectrum.passbands import PassBand, Tophat

__all__ = ['Model']


class Model:
    """Forward spectroscopic model assembled from a configuration."""

    def __init__(self, cfg, root=None, log=None):
        if isinstance(cfg, str):
            cfg = cfg_parser.parse(cfg, root=root)
        self.cfg = cfg
        self.rt_path = cfg.rt_path
        self.maxdepth = cfg.maxdepth

        # Screen-only log by default; the driver passes a file-backed
        # one (reference: mc3.utils.Log threaded everywhere):
        if log is None:
            from .logger import Log
            log = Log(verb=cfg.verb if cfg.verb is not None else 1)
        self.log = log

        from .tools import Timer
        timer = Timer()
        self.timestamps = {}
        self._setup_spectrum()
        self.timestamps['setup spectrum'] = timer.clock()
        self._setup_atmosphere()
        self.timestamps['setup atmosphere'] = timer.clock()
        self._setup_star()
        self._setup_opacity()
        self.timestamps['setup opacity'] = timer.clock()
        self._setup_quadrature()
        self._log_setup_summary()

        # Results from the last run():
        self.spectrum = None
        self.depth = None
        self.ideep = None

    def _log_setup_summary(self):
        log = self.log
        log.head(f'Run mode: {self.cfg.runmode} ({self.rt_path})')
        if self.wn is not None:
            log.msg(
                f'Wavenumber grid: {float(self.wn[0]):.3f} -- '
                f'{float(self.wn[-1]):.3f} cm-1 ({self.nwave} samples)'
            )
        log.msg(
            f'Pressure grid: {float(self.press[0]):.2e} -- '
            f'{float(self.press[-1]):.2e} bar ({self.nlayers} layers)'
        )
        if self.species is not None:
            log.msg(f'Species: {" ".join(self.species)}')
        for mtype, opac_model, _ in self.opacity_models:
            bounds = ''
            if mtype in self.tmin:
                bounds = (
                    f'  T in [{self.tmin[mtype]:.1f}, '
                    f'{self.tmax[mtype]:.1f}] K'
                )
            log.msg(f'Opacity: {opac_model.name} ({mtype}){bounds}')

    # ------------------------------------------------------------------
    # Setup

    def _setup_spectrum(self):
        cfg = self.cfg
        wnlow = cfg.wnlow
        wnhigh = cfg.wnhigh
        if wnlow is None and cfg.wl_high is not None:
            wnlow = 1.0 / cfg.wl_high
        if wnhigh is None and cfg.wl_low is not None:
            wnhigh = 1.0 / cfg.wl_low

        # Atmosphere-only runs need no spectral grid (reference
        # driver.py:48-51 builds the Atmosphere without a Pyrat):
        if cfg.runmode == 'atmosphere' and wnlow is None \
                and wnhigh is None and cfg.sampled_cs is None:
            self.grid = None
            self.wn = None
            self.nwave = 0
            return

        # Inherit sampling from a cross-section table when present
        # (reference pyrat/spectrum.py:124-166):
        use_cs_sampling = (
            cfg.sampled_cs is not None and cfg.runmode != 'opacity'
        )
        if use_cs_sampling:
            _, _, _, wn = pio.read_opacity(cfg.sampled_cs[0], 'arrays')
            from .opacity.line_sample import wn_mask_tol
            mask = wn_mask_tol(wn, wnlow, wnhigh)
            wn = wn[mask][::cfg.wl_thinning]
            self.grid = WavenumberGrid(wn=wn, wnlow=wnlow, wnhigh=wnhigh)
        else:
            self.grid = wavenumber_grid(
                wnlow=wnlow, wnhigh=wnhigh,
                wnstep=cfg.wnstep, wlstep=cfg.wlstep,
                resolution=cfg.resolution, wnosamp=cfg.wnosamp,
            )
        self.wn = self.grid.wn
        self.nwave = len(self.wn)

    def _setup_atmosphere(self):
        """Per-property calculate/read/interpolate decisions, matching
        the reference's provenance rules
        (pyrat/atmosphere.py:165-262, 933-1065):

        - pressure: calculate iff ptop+pbottom+nlayers are all given,
          else read from the input atmosphere;
        - temperature: a tmodel takes precedence (requires tpars unless
          a read profile exists and tpars is absent), else read;
        - VMR: a chemistry model takes precedence (free needs
          species+uniform_vmr; config species override the file's),
          else read;
        - radius: a radmodel takes precedence, else read;
        - read profiles are interpolated onto a calculated pressure
          grid (T/r slinear vs ln p; VMR log-log).
        """
        cfg = self.cfg
        # Input atmosphere (a ptfile provides only P/T and takes
        # precedence over atmfile; reference atmosphere.py:165-176):
        in_press = in_temp = in_vmr = in_radius = None
        in_species = None
        source = None
        if cfg.ptfile is not None and os.path.isfile(cfg.ptfile):
            source = cfg.ptfile
        elif cfg.atmfile is not None:
            source = cfg.atmfile
        if source is not None:
            units, in_species, in_press, in_temp, in_vmr, in_radius = \
                pio.read_atm(source)
            punits, _, _, runits = units
            in_press = in_press * pc.u(punits) / pc.bar
            if in_radius is not None and runits is not None:
                in_radius = in_radius * pc.u(runits)
            if source == cfg.ptfile:
                in_species = in_vmr = in_radius = None

        # Pressure:
        calc_press = (
            cfg.nlayers is not None and cfg.ptop is not None
            and cfg.pbottom is not None
        )
        if calc_press:
            press = np.asarray(
                profiles.pressure(cfg.ptop, cfg.pbottom, cfg.nlayers),
            )
        elif in_press is not None:
            press = np.asarray(in_press)
        else:
            raise ValueError(
                'Cannot compute pressure profile, either set {ptop, '
                'pbottom, nlayers} parameters, or provide an input PT '
                'profile (ptfile) or atmospheric file (atmfile)'
            )
        nlayers = len(press)

        # Interpolate read profiles onto a calculated grid
        # (reference atmosphere.py:237-262):
        needs_interp = (
            calc_press and in_press is not None
            and (len(in_press) != nlayers
                 or not np.allclose(in_press, press))
        )
        if needs_interp:
            from scipy.interpolate import interp1d
            logp_in = np.log(in_press)
            logp = np.log(press)
            if in_temp is not None:
                in_temp = interp1d(
                    logp_in, in_temp, kind='slinear',
                    bounds_error=False,
                    fill_value=(in_temp[0], in_temp[-1]),
                )(logp)
            if in_vmr is not None:
                log_vmr = np.log(in_vmr)
                in_vmr = np.exp(interp1d(
                    logp_in, log_vmr, axis=0, kind='slinear',
                    bounds_error=False,
                    fill_value=(log_vmr[0], log_vmr[-1]),
                )(logp))
            if in_radius is not None:
                in_radius = interp1d(
                    logp_in, in_radius, kind='slinear',
                )(logp)

        # VMR provenance: chemistry model beats the read profiles;
        # config species beat the file's (reference check_chemistry):
        species = in_species
        vmr = in_vmr
        if cfg.chemistry is not None:
            if cfg.species is not None:
                species = list(cfg.species)
            if species is None:
                raise ValueError(
                    'Cannot compute VMRs. Undefined atmospheric species '
                    'list (species)'
                )
            if cfg.chemistry == 'free':
                if cfg.uniform_vmr is None:
                    raise ValueError(
                        'Undefined list of uniform volume mixing ratios '
                        '(uniform_vmr) for free chemistry model'
                    )
                if len(cfg.uniform_vmr) != len(species):
                    raise ValueError(
                        f'Number of uniform abundances '
                        f'({len(cfg.uniform_vmr)}) does not match the '
                        f'number of species ({len(species)})'
                    )
                vmr = vmr_models.uniform_vmr(
                    np.array(cfg.uniform_vmr, float), nlayers,
                )
            # Calculated composition invalidates any read radius
            # (reference check_altitude: read only when vmr is read):
            in_radius = None

        self.press = press
        self.nlayers = nlayers
        self.species = None if species is None else list(species)
        self.base_temp = in_temp
        self.base_vmr = None if vmr is None else np.asarray(vmr)
        self.input_radius = in_radius

        # Species physical properties (deferred for equilibrium
        # chemistry: the network prunes species without thermodynamic
        # data first, and the equilibrium block below resolves the
        # properties of the pruned list):
        if self.species is not None and cfg.chemistry != 'equilibrium':
            self.mol_mass, self.mol_radius = pio.species_properties(
                self.species, cfg.molfile,
            )
        else:
            self.mol_mass = self.mol_radius = None

        # Temperature model:
        self.temp_model = None
        self.tpars = None if cfg.tpars is None else np.asarray(cfg.tpars)
        if cfg.tmodelname is not None:
            self.temp_model = profiles.get_tmodel(
                cfg.tmodelname, self.press,
            )
            # The model takes precedence over any input profile, so its
            # parameters are required (reference test_transmission.py:321)
            # -- unless a retrieval_params block may provide them (the
            # check then happens after parameter mapping, reference
            # retrieval.py:286-314), or runmode=atmosphere with a read
            # temperature profile (reference check_temperature 'read'):
            reads_temp = (
                cfg.runmode == 'atmosphere' and self.base_temp is not None
            )
            if self.tpars is None and cfg.retrieval_params is None \
                    and not reads_temp:
                raise ValueError(
                    'Not all temperature parameters were defined (tpars)'
                )

        # Equilibrium chemistry (reference pyrat/atmosphere.py:289-296
        # via chemcat; here the native Gibbs-minimization network,
        # atmosphere/chem.py):
        self.chemistry = cfg.chemistry
        self.chem_model = None
        self._equil_fn = None
        if cfg.chemistry == 'equilibrium':
            # The chemistry model takes precedence over any input VMR
            # profile (reference Atmosphere calc/read decision,
            # pyrat/atmosphere.py:205-217); cfg species override the
            # input atmosphere's:
            if cfg.species is not None:
                # Properties are resolved after the network prunes
                # species without thermodynamic data:
                self.species = list(cfg.species)
                self.base_vmr = None
            if self.species is None:
                raise ValueError(
                    'chemistry=equilibrium requires atmospheric species'
                )
            temp0 = self.base_temp
            if temp0 is None:
                if self.temp_model is None or self.tpars is None:
                    raise ValueError(
                        'chemistry=equilibrium requires a temperature '
                        'profile (tmodel/tpars or an input atmosphere)'
                    )
                temp0 = np.asarray(self.temp_model(self.tpars))
            e_source = cfg.solar or 'asplund_2021'
            if isinstance(e_source, str) and e_source not in \
                    chem.SOLAR_ABUNDANCES:
                e_source = chem.read_solar_file(e_source)
            self.chem_model = chem.Network(
                self.press, temp0, self.species, e_source=e_source,
            )
            self.chem_model.thermochemical_equilibrium()
            self.species = [str(s) for s in self.chem_model.species]
            self.mol_mass, self.mol_radius = pio.species_properties(
                self.species, cfg.molfile,
            )
            self.base_vmr = np.asarray(self.chem_model.vmr)
            self.base_temp = np.asarray(temp0)
            self._equil_fn = chem.jit_equilibrium_fn(self.chem_model)

        # Planet parameters; mplanet/gplanet/rplanet kept consistent
        # (reference MassGravity descriptor, pyrat/atmosphere.py:20-48):
        self.rplanet = cfg.rplanet
        mplanet, gplanet = cfg.mplanet, cfg.gplanet
        if self.rplanet is not None:
            if gplanet is not None and mplanet is None:
                mplanet = gplanet * self.rplanet**2 / pc.G
            if mplanet is not None:
                gplanet = pc.G * mplanet / self.rplanet**2
        self.mplanet = mplanet
        self.gplanet = gplanet
        self.refpressure = cfg.refpressure
        self.rmodelname = cfg.rmodelname
        self.smaxis = cfg.smaxis
        self.mstar = cfg.mstar
        self.rstar = cfg.rstar
        self.tstar = cfg.tstar
        self.tint = cfg.tint
        self.beta_irr = cfg.beta_irr
        self.distance = cfg.distance
        self.rhill = hydro.hill_radius(self.smaxis, self.mplanet, self.mstar)
        # Static radius scale for float32-safe transit geometry (chord
        # lengths come from differences of squared radii; computing them
        # on O(1) values keeps full relative precision):
        if self.rplanet is not None:
            self._radius_scale = float(self.rplanet)
        elif self.input_radius is not None:
            self._radius_scale = float(np.mean(self.input_radius))
        else:
            self._radius_scale = 1.0

        # Free-VMR parameterization (vmr_vars config):
        self._setup_vmr_models()

    def _setup_vmr_models(self):
        cfg = self.cfg
        vmr_vars = cfg.vmr_vars or ''
        lines = [ln for ln in vmr_vars.splitlines() if ln.strip()]
        self.vmr_var_names = []
        self.vmr_pars = []
        has_pars = any(
            _is_number(val) for ln in lines for val in ln.split()[1:]
        )
        may_retrieve = cfg.retrieval_params is not None
        for ln in lines:
            fields = ln.split()
            if has_pars:
                self.vmr_var_names.append(fields[0])
                if len(fields) < 2:
                    # Values may come from retrieval_params instead
                    # (checked after parameter mapping,
                    # reference retrieval.py:296-317):
                    if not may_retrieve:
                        raise ValueError(
                            'Not all vmr parameter values were defined '
                            '(vmr_vars)'
                        )
                    self.vmr_pars.append(None)
                    continue
                self.vmr_pars.append(np.array(fields[1:], float))
            else:
                self.vmr_var_names.extend(fields)
        if not has_pars:
            self.vmr_pars = None
            if self.vmr_var_names and not may_retrieve:
                raise ValueError(
                    'Not all vmr parameter values were defined (vmr_vars)'
                )

        # Build the VMR evaluators.  Free models (log_/scale_/slant_)
        # act on one species; equilibrium models ([M/H], [X/H], X/Y)
        # re-scale the element abundances of the chemistry network
        # (reference pyrat/atmosphere.py:600-630):
        self.ifree = []
        self._vmr_kinds = []
        self._equil_info = []
        is_equil_chem = self.chem_model is not None
        elements = (
            list(self.chem_model.elements) if is_equil_chem else []
        )
        species = self.species or []
        for var in self.vmr_var_names:
            info = None
            if var.startswith('log_'):
                mol, kind = var[4:], 'iso'
            elif var.startswith('scale_'):
                mol, kind = var[6:], 'scale'
            elif var.startswith('slant_'):
                mol, kind = var[6:], 'slant'
            elif var == '[M/H]':
                mol, kind = None, 'metal_equil'
            elif var.startswith('[') and var.endswith('/H]'):
                mol, kind = None, 'scale_equil'
                element = var[1:-3]
                if not is_equil_chem or element not in elements:
                    raise ValueError(
                        f"Invalid vmr_vars variable '{var}', element "
                        f"'{element}' is not in the atmosphere"
                    )
                info = elements.index(element)
            elif '/' in var:
                mol, kind = None, 'ratio_equil'
                num, den = var.split('/')
                if not is_equil_chem or num not in elements \
                        or den not in elements:
                    raise ValueError(
                        f"Invalid vmr_vars variable '{var}', elements "
                        'are not in the atmosphere'
                    )
                info = (elements.index(num), elements.index(den))
            else:
                raise ValueError(f"Unrecognized VMR model (vmr_vars): '{var}'")
            if kind in ('metal_equil', 'scale_equil', 'ratio_equil') \
                    and not is_equil_chem:
                raise ValueError(
                    f"vmr_vars variable '{var}' requires "
                    'chemistry=equilibrium'
                )
            if mol is not None:
                if mol not in species:
                    raise ValueError(
                        f"Invalid vmr_vars variable '{var}', species {mol} "
                        'is not in the atmosphere'
                    )
                imol = species.index(mol)
                if is_equil_chem:
                    # Hybrid: free VMR on top of equilibrium, capped by
                    # element availability (vmr_models.hybrid_vmr):
                    if kind != 'iso':
                        raise ValueError(
                            f"vmr_vars variable '{var}': only log_X free "
                            'models combine with chemistry=equilibrium'
                        )
                    kind = 'hybrid'
                    stoich = self.chem_model.stoich_vals
                    icols = np.where(stoich[imol] != 0)[0]
                    info = (
                        imol,
                        stoich[:, icols].astype(float),
                        stoich[imol, icols].astype(float),
                    )
                else:
                    self.ifree.append(imol)
            self._vmr_kinds.append(kind)
            self._equil_info.append(info)

        self.bulk = cfg.bulk
        self.ibulk = None
        self.bulkratio = self.invsrat = None
        if self.bulk is not None:
            missing = np.setdiff1d(self.bulk, species)
            if len(missing):
                raise ValueError(
                    f'These bulk species are not present in the '
                    f'atmosphere: {missing}'
                )
            self.ibulk = [species.index(mol) for mol in self.bulk]
            # Host-side (setup must not dispatch eager device ops):
            bratio = self.base_vmr[:, self.ibulk] \
                / self.base_vmr[:, [self.ibulk[0]]]
            bratio[:, 0] = 1.0
            self.bulkratio = bratio
            self.invsrat = 1.0 / np.sum(bratio, axis=1)

    def _setup_star(self):
        cfg = self.cfg
        self.starflux = None
        # Temperature-gridded SED (enables retrieving tstar with a real
        # stellar spectrum, reference pyrat/argum.py:95-98):
        self.sed_temps = None
        self.sed_fluxes = None
        self.star_is_blackbody = False
        if cfg.starspec is not None:
            spectra, starwn, sed_temps = pio.read_spectra(cfg.starspec)
            fluxes = np.stack([
                np.interp(self.wn, starwn, flux) for flux in spectra
            ])
            if sed_temps is not None:
                self.sed_temps = np.asarray(sed_temps)
                self.sed_fluxes = fluxes
                tstar = self.tstar if self.tstar is not None \
                    else sed_temps[0]
                self.starflux = _interp_sed(fluxes, sed_temps, tstar)
            else:
                self.starflux = fluxes[0]
        elif cfg.kurucz is not None:
            if self.tstar is None or cfg.log_gstar is None:
                raise ValueError(
                    'Undefined stellar temperature or gravity for Kurucz'
                )
            flux, starwn, _, _ = read_kurucz(
                cfg.kurucz, self.tstar, cfg.log_gstar,
            )
            self.starflux = np.interp(self.wn, starwn, flux)
        elif self.tstar is not None:
            self.starflux = np.asarray(bbflux(self.wn, self.tstar))
            self.star_is_blackbody = True

    def _setup_opacity(self):
        """Assemble the opacity model list (order matches reference
        pyrat/opacity.py:52-203)."""
        cfg = self.cfg
        self.opacity_models = []   # (type, model, imol)
        self.tmin = {}
        self.tmax = {}
        species = self.species or []
        wn = self.wn

        if cfg.sampled_cs is not None and cfg.runmode != 'opacity':
            temp_array = None
            if (cfg.tmin is not None and cfg.tmax is not None
                    and cfg.tstep is not None):
                ntemp = int((cfg.tmax - cfg.tmin) / cfg.tstep) + 1
                tmax = cfg.tmin + (ntemp - 1) * cfg.tstep
                temp_array = np.linspace(cfg.tmin, tmax, ntemp)
            ls = LineSample(
                cfg.sampled_cs, pressure=self.press, temperature=temp_array,
                min_wn=self.grid.wnlow, max_wn=self.grid.wnhigh,
                wl_thinning=cfg.wl_thinning,
                isotope_ratios=cfg.isotope_ratios,
            )
            imol = [species.index(mol) for mol in ls.species]
            self.opacity_models.append(('line_sample', ls, imol))
            self.tmin['line_sample'] = ls.tmin
            self.tmax['line_sample'] = ls.tmax

        if cfg.tlifile is not None:
            from .opacity.lbl import LineByLine
            if self.grid.own is None:
                # A table-inherited spectral sampling has no fine
                # (oversampled) grid, which line-by-line requires (the
                # reference hits the same conflict: its table branch
                # returns before building spec.own, spectrum.py:124-166):
                raise ValueError(
                    'Line-by-line opacity (tlifile) requires an explicit '
                    'spectral sampling (resolution, wnstep, or wlstep); '
                    'it cannot inherit the sampling from a cross-section '
                    'table (sampled_cross_sec). Remove tlifile or set a '
                    'sampling rate.'
                )
            lbl = LineByLine(
                cfg.tlifile, wn=wn, species=species,
                mol_mass=self.mol_mass, mol_radius=self.mol_radius,
                voigt_extent=cfg.voigt_extent,
                voigt_cutoff=cfg.voigt_cutoff,
                ethresh=cfg.ethresh,
                wnosamp=self.grid.wnosamp,
                ownstep=self.grid.ownstep,
                own=self.grid.own,
                odivisors=self.grid.odivisors,
                pressure=self.press,
                tmin=cfg.tmin, tmax=cfg.tmax,
                ndop=cfg.voigt_ndop, nlor=cfg.voigt_nlor,
                dmin=cfg.voigt_dmin, dmax=cfg.voigt_dmax,
                lmin=cfg.voigt_lmin, lmax=cfg.voigt_lmax,
                dlratio=cfg.voigt_dlratio,
                resolution_mode=self.grid.resolution is not None,
                single_isotope=cfg.single_isotope,
            )
            imol = [species.index(mol) for mol in lbl.species]
            self.opacity_models.append(('lbl', lbl, imol))
            self.tmin['lbl'] = lbl.tmin
            self.tmax['lbl'] = lbl.tmax

        if cfg.alkali_models is not None:
            for name in cfg.alkali_models:
                model = get_alkali_model(
                    name, self.press, wn, cutoff=cfg.alkali_cutoff,
                )
                imol = species.index(model.species)
                self.opacity_models.append(('alkali', model, imol))

        if cfg.continuum_cs is not None:
            tmins, tmaxs = [], []
            for cs_file in cfg.continuum_cs:
                if not os.path.isfile(cs_file):
                    # Fall back to the bundled CIA library by basename
                    # (so reference-style configs run with zero
                    # user-supplied data files):
                    from .data import cia_file as bundled_cia
                    try:
                        cs_file = bundled_cia(cs_file)
                    except FileNotFoundError:
                        pass
                cia = CIA(cs_file, wn=wn)
                imol = [species.index(mol) for mol in cia.species]
                self.opacity_models.append(('cia', cia, imol))
                tmins.append(cia.tmin)
                tmaxs.append(cia.tmax)
            self.tmin['cia'] = np.amax(tmins)
            self.tmax['cia'] = np.amin(tmaxs)

        if cfg.rayleigh is not None:
            for name in cfg.rayleigh:
                mol = name.split('_')[1]
                model = Rayleigh(mol, wn)
                imol = species.index(mol)
                self.opacity_models.append(('rayleigh', model, imol))

        cloud_names, cloud_pars = cfg_parser.parse_var_vals(cfg.clouds)
        for name, pars in zip(cloud_names, cloud_pars):
            if name == 'ccsgray':
                model = CCSgray(self.press, wn)
            elif name == 'deck':
                model = Deck(self.press, wn)
            elif name == 'lecavelier':
                model = Lecavelier(self.press, wn)
            if pars is None:
                # Values must come from retrieval_params; the mapping
                # step errors on any slot left undefined (reference
                # pyrat/opacity.py:182-183, retrieval.py:318-323):
                model.pars = [np.nan] * model.npars
            else:
                if len(pars) != model.npars:
                    raise ValueError(
                        f'Number of input parameters ({len(pars)}) does not '
                        f'match required ({model.npars}) for model {name!r}'
                    )
                model.pars = list(np.asarray(pars, float))
            self.opacity_models.append(('cloud', model, None))

        if cfg.h_ion_model is not None:
            model = HydrogenIon(wn)
            imol = [species.index(mol) for mol in model.species]
            self.opacity_models.append(('h_ion', model, imol))

        self.fpatchy = cfg.fpatchy
        self.is_patchy = self.fpatchy is not None
        self.has_deck = any(
            m.name == 'deck' for _, m, _ in self.opacity_models
        )

    def _setup_quadrature(self):
        cfg = self.cfg
        if cfg.quadrature is not None:
            mu, weights = rt.gauss_quadrature(cfg.quadrature)
        else:
            raygrid = np.asarray(cfg.raygrid) * sc.degree
            mu = np.cos(raygrid)
            bounds = np.linspace(0, 0.5 * np.pi, len(raygrid) + 1)
            bounds[1:-1] = 0.5 * (raygrid[:-1] + raygrid[1:])
            weights = np.pi * (
                np.sin(bounds[1:])**2 - np.sin(bounds[:-1])**2
            )
        self.quadrature_mu = mu
        self.quadrature_weights = weights

    # ------------------------------------------------------------------
    # Opacity tabulation (runmode = opacity)

    def compute_opacity(self, engine='parity'):
        """Tabulate LBL cross sections over a (T, layer, wave) grid and
        write them to the sampled_cross_sec npz file.

        engine='parity' reproduces the reference's profile-grid
        sampling exactly (pyratbay/pyrat/extinction.py:14-126, with
        grid-temperature densities); engine='direct' uses the
        exact-Voigt device engine (faster and free of the profile grid's
        few-percent quantization).
        """
        cfg = self.cfg
        if cfg.sampled_cs is None:
            raise ValueError(
                'Undefined output cross-section file (sampled_cross_sec) '
                'needed to compute opacity table'
            )
        if cfg.tmin is None or cfg.tmax is None or cfg.tstep is None:
            raise ValueError(
                'Undefined temperature sampling (tmin/tmax/tstep) needed '
                'to compute opacity table'
            )
        lbl = None
        for mtype, model, _ in self.opacity_models:
            if mtype == 'lbl':
                lbl = model
        if lbl is None:
            raise ValueError(
                'Undefined input TLI files (tlifile) needed to compute '
                'opacity table'
            )
        if len(lbl.species) > 1:
            raise ValueError(
                'Cross-section files must be for a single species only, '
                'but line-by-line data include transitions for multiple '
                f'ones: {lbl.species}'
            )
        if cfg.tmin < lbl.tmin or cfg.tmax > lbl.tmax:
            raise ValueError(
                'Requested cross-section table temperatures '
                f'[{cfg.tmin:.1f}, {cfg.tmax:.1f}] K lie outside the TLI '
                f'range [{lbl.tmin:.1f}, {lbl.tmax:.1f}] K'
            )
        ntemp = int((cfg.tmax - cfg.tmin) / cfg.tstep) + 1
        temps = np.linspace(
            cfg.tmin, cfg.tmin + (ntemp - 1) * cfg.tstep, ntemp,
        )
        vmr = self.base_vmr
        if engine == 'direct':
            # Fast path: exact-Voigt direct evaluation, vmapped
            # over (T, layer) cells (opacity/lbl_tpu.py):
            from .opacity.lbl_tpu import DirectLBL
            direct = DirectLBL(lbl)
            table = np.asarray(
                direct.tabulate(temps, self.press, vmr), float,
            )
        else:
            table = np.zeros((ntemp, self.nlayers, self.nwave))
            for itemp, temp_val in enumerate(temps):
                temp_profile = np.full(self.nlayers, temp_val)
                dens = np.asarray(vmr) * (
                    self.press[:, None] * pc.bar / (pc.k * temp_val)
                )
                table[itemp] = lbl.cross_section(temp_profile, dens)
        pio.write_opacity(
            cfg.sampled_cs[0], str(lbl.species[0]), temps, self.press,
            self.wn, table,
        )
        self.cs_table = table
        self.cs_temps = temps
        return table

    # ------------------------------------------------------------------
    # Forward evaluation

    def model_pars(self):
        """Current parameter arrays per opacity model (None if no pars)."""
        return [
            jnp.asarray(np.array(model.pars, float))
            if getattr(model, 'npars', 0) > 0 else None
            for _, model, _ in self.opacity_models
        ]

    def eval_temp(self, tpars=None):
        if tpars is not None and self.temp_model is not None:
            return self.temp_model(jnp.asarray(tpars))
        if self.temp_model is not None and self.tpars is not None:
            return self.temp_model(jnp.asarray(self.tpars))
        if self.base_temp is None:
            raise ValueError('No temperature profile available')
        return jnp.asarray(self.base_temp)

    def eval_vmr(self, vmr_pars=None, temp=None):
        """Apply VMR models (free, equilibrium, hybrid) to get the
        composition; jit-safe (shared with retrieval/forward.py)."""
        if vmr_pars is None:
            vmr_pars = self.vmr_pars
        if self.chem_model is not None and temp is None:
            temp = self.eval_temp()
        return self._eval_vmr_pure(vmr_pars, temp)

    def _eval_vmr_pure(self, vmr_par_list, temp):
        """Pure VMR evaluation: equilibrium chemistry re-solve with
        metallicity/[X/H]/X-Y parameters plus hybrid free overrides
        (reference pyrat/atmosphere.py:444-475), or free-VMR models
        with bulk balancing."""
        base = jnp.asarray(self.base_vmr)

        if self.chem_model is not None:
            has_pars = vmr_par_list is not None and any(
                p is not None for p in (vmr_par_list or [])
            )
            if not has_pars:
                # Composition depends on temperature: re-solve at the
                # current profile (the reference re-runs chemcat every
                # sample and radeq iteration, pyrat/atmosphere.py:445-465)
                # unless temp is statically the setup profile, for which
                # base_vmr is already the solution:
                if temp is None:
                    return base
                is_static = not isinstance(temp, jax.core.Tracer)
                if is_static and self.base_temp is not None \
                        and np.array_equal(
                            np.asarray(temp), np.asarray(self.base_temp)):
                    return base
                return self._equil_fn(jnp.asarray(temp))
            metallicity = 0.0
            nelem = len(self.chem_model.elements)
            escale = jnp.zeros(nelem)
            ratios = []
            hybrids = []
            for kind, info, pars in zip(
                    self._vmr_kinds, self._equil_info, vmr_par_list):
                if pars is None:
                    continue
                val = jnp.squeeze(jnp.asarray(pars))
                if kind == 'metal_equil':
                    metallicity = val
                elif kind == 'scale_equil':
                    escale = escale.at[info].set(val)
                elif kind == 'ratio_equil':
                    ratios.append((info[0], info[1], val))
                elif kind == 'hybrid':
                    hybrids.append((*info, val))
            vmr = self._equil_fn(
                jnp.asarray(temp), metallicity, escale, tuple(ratios),
            )
            for imol, stoich_cols, mol_stoich, val in hybrids:
                cap = chem.hybrid_max_vmr(vmr, stoich_cols, mol_stoich)
                vmr = vmr.at[:, imol].set(
                    jnp.clip(10.0 ** val, 0.0, cap),
                )
            return vmr

        if vmr_par_list is None or not self.ifree:
            return base
        log_press = np.log10(self.press)
        profiles_list = []
        for kind, imol, pars in zip(
                self._vmr_kinds, self.ifree, vmr_par_list):
            if kind == 'iso':
                prof = vmr_models.iso_vmr(jnp.asarray(pars), self.nlayers)
            elif kind == 'scale':
                prof = vmr_models.scale_vmr(base[:, imol], jnp.asarray(pars))
            else:
                prof = vmr_models.slant_vmr(log_press, jnp.asarray(pars))
            profiles_list.append(prof)
        return vmr_models.vmr_scale(
            base, profiles_list, tuple(self.ifree),
            np.asarray(self.ibulk), self.bulkratio, self.invsrat,
        )

    def eval_radius(self, temp, mm, radius=None):
        if radius is not None:
            return jnp.asarray(radius)
        if self.rmodelname == 'hydro_m':
            return hydro.hydro_m(
                self.press, temp, mm, self.mplanet,
                self.refpressure, self.rplanet,
            )
        if self.rmodelname == 'hydro_g':
            return hydro.hydro_g(
                self.press, temp, mm, self.gplanet,
                self.refpressure, self.rplanet,
            )
        if self.input_radius is not None:
            return jnp.asarray(self.input_radius)
        return None

    def direct_lbl(self, lbl):
        """Cached DirectLBL engine for an lbl opacity model (the
        jit-safe exact-Voigt evaluator, opacity/lbl_tpu.py)."""
        if not hasattr(self, '_direct_lbl'):
            self._direct_lbl = {}
        key = id(lbl)
        if key not in self._direct_lbl:
            from .opacity.lbl_tpu import DirectLBL
            # Build against the model's output grid (it may have been
            # pad-extended for wave sharding, parallel/sharded.py):
            self._direct_lbl[key] = DirectLBL(lbl, wn=self.wn)
        return self._direct_lbl[key]

    def extinction(self, temp, radius, dens, pars_list=None, skip=(),
                   lbl_engine='parity'):
        """Total extinction coefficient [nlayers, nwave] (cm-1), the
        separate cloud extinction for patchy models, and the deck
        surface triple.

        lbl_engine: 'parity' (host profile-grid sampler, golden-exact)
        or 'direct' (jit-safe exact-Voigt engine; required inside the
        jitted retrieval forward).
        """
        if pars_list is None:
            pars_list = self.model_pars()
        ec = jnp.zeros((self.nlayers, self.nwave))
        ec_cloud = jnp.zeros((self.nlayers, self.nwave))
        deck_surface = None
        for (mtype, model, imol), pars in zip(
                self.opacity_models, pars_list):

            skipped = model.name in skip or mtype in skip
            if model.name == 'deck':
                if skipped:
                    deck_surface = None
                    continue
                deck_surface = model.surface(radius, temp, pars)
                continue
            if skipped:
                continue

            if mtype == 'line_sample':
                density = dens[:, jnp.asarray(imol)]
                sk = jnp.asarray([
                    1.0 if mol not in skip else 0.0 for mol in model.species
                ])
                contrib = model.extinction(
                    temp, density * sk[None, :], pars=pars,
                )
            elif mtype == 'lbl':
                if lbl_engine == 'direct':
                    contrib = self.direct_lbl(model).extinction_fn()(
                        temp, dens,
                    )
                else:
                    contrib = model.extinction(temp, dens, skip=skip)
            elif mtype == 'alkali':
                contrib = model.extinction(temp, dens[:, imol])
            elif mtype == 'cia':
                contrib = model.extinction(temp, dens[:, jnp.asarray(imol)])
            elif mtype == 'rayleigh':
                contrib = model.extinction(dens[:, imol])
            elif mtype == 'cloud':
                contrib = model.extinction(temp, pars)
            elif mtype == 'h_ion':
                contrib = model.extinction(
                    temp, dens[:, imol[0]], dens[:, imol[1]],
                )
            else:
                raise ValueError(f'Unknown opacity type {mtype}')

            if mtype == 'cloud' and self.is_patchy:
                ec_cloud = ec_cloud + contrib
            else:
                ec = ec + contrib
        return ec, ec_cloud, deck_surface

    def check_temp_bounds(self, temp):
        """List of models whose T-tables the profile falls outside of."""
        tmin = float(np.amin(temp))
        tmax = float(np.amax(temp))
        oob = [name for name, t in self.tmin.items() if tmin < t]
        oob += [name for name, t in self.tmax.items() if tmax > t]
        return sorted(set(oob))

    def _rtop(self, radius):
        if not np.isfinite(self.rhill):
            return 0
        inside = radius < self.rhill
        return jnp.where(jnp.any(inside), jnp.argmax(inside), 0)

    def _run_transit(self, ec, ec_cloud, deck_surface, radius, rtop,
                     fpatchy):
        nlayers = self.nlayers
        if deck_surface is not None:
            deck_itop, rsurf, tsurf = deck_surface
            ibottom = deck_itop + 1
        else:
            deck_itop = rsurf = None
            ibottom = nlayers

        # Radius-normalized geometry (float32-safe; scale cancels in
        # the (Rp/Rs)^2 output):
        rscale = self._radius_scale
        rr = radius / rscale
        rstar_n = self.rstar / rscale
        rsurf_n = None if rsurf is None else rsurf / rscale

        ec_total = ec + ec_cloud if self.is_patchy else ec
        path = geometry.transit_path_matrix(rr, rtop) * rscale

        depth, ideep = rt.transit_depth(
            ec_total, path, self.maxdepth, rtop, ibottom,
        )
        spectrum = rt.transmission_spectrum(
            depth, ideep, rr, rstar_n, rtop,
            deck_rsurf=rsurf_n, deck_itop=deck_itop,
        )
        result = {'spectrum': spectrum, 'depth': depth, 'ideep': ideep}
        if self.is_patchy:
            cloudy = spectrum
            depth_clear, ideep_clear = rt.transit_depth(
                ec, path, self.maxdepth, rtop, nlayers,
            )
            clear = rt.transmission_spectrum(
                depth_clear, ideep_clear, rr, rstar_n, rtop,
            )
            result['cloudy'] = cloudy
            result['clear'] = clear
            result['depth_clear'] = depth_clear
            result['ideep_clear'] = ideep_clear
            result['spectrum'] = fpatchy * cloudy + (1 - fpatchy) * clear
        return result

    def _run_emission(self, ec, ec_cloud, deck_surface, temp, radius, rtop,
                      fpatchy):
        nlayers = self.nlayers
        wn = jnp.asarray(self.wn)
        if deck_surface is not None:
            deck_itop, _, tsurf = deck_surface
            ibottom = deck_itop + 1
        else:
            deck_itop = tsurf = None
            ibottom = nlayers

        two_stream = 'two_stream' in self.rt_path
        maxdepth = np.inf if two_stream else self.maxdepth

        ec_total = ec + ec_cloud if self.is_patchy else ec
        depth, ideep = rt.plane_parallel_depth(
            ec_total, radius, maxdepth, rtop, ibottom,
        )
        bbody = blackbody_wn(wn, temp[:, None])

        if two_stream:
            f_int = rt.internal_flux(wn, self.tint)
            if (self.starflux is not None and self.smaxis is not None
                    and self.rstar is not None):
                fdown_top = (
                    self.beta_irr * (self.rstar / self.smaxis)**2
                    * jnp.asarray(self.starflux)
                )
            else:
                fdown_top = jnp.zeros(self.nwave)
            flux_up, flux_down = rt.two_stream(
                depth, bbody, wn, fdown_top, f_int,
            )
            return {
                'spectrum': flux_up[0], 'fplanet': flux_up[0],
                'flux_up': flux_up, 'flux_down': flux_down,
                'depth': depth, 'ideep': ideep, 'bbody': bbody,
            }

        if deck_surface is not None:
            bb_surf = blackbody_wn(wn, tsurf)
            bbody = bbody.at[deck_itop].set(bb_surf)
            ideep = jnp.clip(ideep, 0, deck_itop)
        intensity = rt.plane_parallel_intensity(
            depth, bbody, self.quadrature_mu, ideep, rtop,
        )
        weights = jnp.asarray(self.quadrature_weights)[:, None]
        flux = jnp.sum(intensity * weights, axis=0)
        result = {
            'spectrum': flux, 'fplanet': flux, 'intensity': intensity,
            'depth': depth, 'ideep': ideep, 'bbody': bbody,
        }
        if self.is_patchy:
            cloudy = flux
            depth_clear, ideep_clear = rt.plane_parallel_depth(
                ec, radius, maxdepth, rtop, nlayers,
            )
            bbody_clear = blackbody_wn(wn, temp[:, None])
            intensity_clear = rt.plane_parallel_intensity(
                depth_clear, bbody_clear, self.quadrature_mu,
                ideep_clear, rtop,
            )
            clear = jnp.sum(intensity_clear * weights, axis=0)
            result['cloudy'] = cloudy
            result['clear'] = clear
            result['spectrum'] = fpatchy * cloudy + (1 - fpatchy) * clear
            result['fplanet'] = result['spectrum']
        return result

    def run(self, temp=None, vmr=None, radius=None, skip=(),
            tpars=None, vmr_pars=None, pars_list=None, fpatchy=None):
        """Evaluate the forward model; returns a result dict and stores
        .spectrum/.depth/.ideep."""
        from .tools import Timer
        timer = Timer()
        if not hasattr(self, 'timestamps'):
            self.timestamps = {}
        temp = self.eval_temp(tpars) if temp is None else jnp.asarray(temp)

        # Out-of-bounds temperature rejection (reference run():189-200):
        oob = self.check_temp_bounds(np.asarray(temp))
        if oob or bool(np.any(np.asarray(temp) <= 0)):
            self.spectrum = np.zeros(self.nwave)
            return {
                'spectrum': jnp.zeros(self.nwave),
                'out_of_bounds': oob or ['temperature'],
            }

        if vmr is None:
            vmr = self.eval_vmr(vmr_pars, temp=temp)
        else:
            vmr = jnp.asarray(vmr)
        dens = hydro.ideal_gas_density(vmr, self.press, temp)
        mm = hydro.mean_weight(vmr, self.mol_mass)
        radius = self.eval_radius(temp, mm, radius)
        rtop = self._rtop(radius) if radius is not None else 0

        self.timestamps['atmosphere'] = timer.clock()
        ec, ec_cloud, deck_surface = self.extinction(
            temp, radius, dens, pars_list, skip,
        )
        self.timestamps['extinction'] = timer.clock()
        if fpatchy is None:
            fpatchy = self.fpatchy

        if self.rt_path in pc.TRANSMISSION_RT:
            result = self._run_transit(
                ec, ec_cloud, deck_surface, radius, rtop, fpatchy,
            )
        else:
            result = self._run_emission(
                ec, ec_cloud, deck_surface, temp, radius, rtop, fpatchy,
            )
        self.timestamps['spectrum'] = timer.clock()

        # Eclipse: Fp/Fs scaled by (Rp/Rs)^2:
        if self.rt_path in pc.ECLIPSE_RT:
            if self.starflux is None:
                raise ValueError(
                    'Undefined stellar flux model, required for eclipse'
                )
            fstar_rprs = (
                1.0 / jnp.asarray(self.starflux)
                * (self.rplanet / self.rstar)**2
            )
            result['fplanet'] = result['spectrum']
            result['spectrum'] = result['spectrum'] * fstar_rprs
            if self.is_patchy:
                result['clear'] = result['clear'] * fstar_rprs
                result['cloudy'] = result['cloudy'] * fstar_rprs

        self.spectrum = np.asarray(result['spectrum'])
        self.depth = result.get('depth')
        self.ideep = result.get('ideep')
        # Patchy split components (reference spec.clear/spec.cloudy,
        # pyrat/spectrum.py:351-409) + emission Planck grid, kept for
        # contribution-function diagnostics (band_contribution):
        self.clear = (
            None if 'clear' not in result
            else np.asarray(result['clear'])
        )
        self.cloudy = (
            None if 'cloudy' not in result
            else np.asarray(result['cloudy'])
        )
        self.depth_clear = result.get('depth_clear')
        self.ideep_clear = result.get('ideep_clear')
        self.bbody = result.get('bbody')
        self._last_fpatchy = fpatchy
        self.temp = np.asarray(temp)
        self.radius = None if radius is None else np.asarray(radius)
        self.vmr = np.asarray(vmr)
        self.log.msg(
            'Forward model done: '
            + ', '.join(
                f'{key} {val:.3f}s' for key, val in
                self.timestamps.items()
                if key in ('atmosphere', 'extinction', 'spectrum')
            )
        )
        return result


    # ------------------------------------------------------------------
    # Diagnostics

    def get_ec(self, layer, temp=None, vmr=None):
        """Per-model extinction contributions at one layer.

        Returns (ec [nmodels_expanded, nwave], labels), the reference's
        opacity.get_ec diagnostic (pyrat/opacity.py:260-307).
        """
        temp = self.eval_temp() if temp is None else jnp.asarray(temp)
        vmr = self.eval_vmr() if vmr is None else jnp.asarray(vmr)
        dens = hydro.ideal_gas_density(vmr, self.press, temp)
        mm = hydro.mean_weight(vmr, self.mol_mass)
        radius = self.eval_radius(temp, mm)
        pars_list = self.model_pars()

        rows = []
        labels = []
        for (mtype, model, imol), pars in zip(
                self.opacity_models, pars_list):
            if model.name == 'deck':
                # Reference get_ec deck row: a 0/1 flag for whether the
                # requested layer is below the cloud top
                # (clouds/gray.py:146-149):
                itop = np.asarray(
                    model.surface(radius, temp, pars)[0],
                )
                rows.append(jnp.full(
                    (1, self.nwave), float(int(layer > itop)),
                ))
                labels.append('deck')
                continue
            if mtype == 'line_sample':
                contrib = model.extinction(
                    temp, dens[:, jnp.asarray(imol)], per_mol=True,
                )[:, layer]
                rows.append(contrib)
                labels += list(model.species)
                continue
            if mtype == 'lbl':
                contrib = model.cross_section(
                    np.asarray(temp), np.asarray(dens), layer=layer,
                    per_mol=True,
                )[:, layer]
                dens_np = np.asarray(dens)
                mol_idx = [
                    self.species.index(mol) for mol in model.species
                ]
                contrib = contrib * dens_np[layer, mol_idx][:, None]
                rows.append(jnp.asarray(contrib))
                labels += list(model.species)
                continue
            if mtype == 'alkali':
                contrib = model.extinction(temp, dens[:, imol])
                labels.append(model.species)
            elif mtype == 'cia':
                contrib = model.extinction(
                    temp, dens[:, jnp.asarray(imol)])
                labels.append(model.name)
            elif mtype == 'rayleigh':
                contrib = model.extinction(dens[:, imol])
                labels.append(model.name)
            elif mtype == 'cloud':
                contrib = model.extinction(temp, pars)
                labels.append(model.name)
            elif mtype == 'h_ion':
                contrib = model.extinction(
                    temp, dens[:, imol[0]], dens[:, imol[1]])
                labels.append(model.name)
            rows.append(contrib[layer][None, :])
        return jnp.concatenate(rows, axis=0), labels

    def band_contribution(self, obs, result=None):
        """Band-averaged contribution functions (emission) or
        transmittances (transmission) at each band of `obs`.

        Reference semantics (pyrat/pyrat_obj.py:671-696 +
        spectrum/contribution_funcs.py): transit geometry gives the
        patchy-mixed transmittance e^-tau; emission gives the Knutson
        et al. (2009) contribution function B * d(e^-tau)/dlnp; both are
        response-weighted over each band and max-normalized per band.

        result: an RT output dict (from run() or a build_forward call)
        holding depth/ideep/bbody/...; defaults to the state stored by
        the last run().  Returns [nlayers, nbands] (numpy).
        """
        from .spectrum import contribution as cfuncs
        if result is not None:
            depth = result['depth']
            ideep = result['ideep']
            bbody = result.get('bbody')
            depth_clear = result.get('depth_clear')
            ideep_clear = result.get('ideep_clear')
            fpatchy = result.get('fpatchy', self.fpatchy)
        else:
            depth, ideep, bbody = self.depth, self.ideep, self.bbody
            depth_clear = self.depth_clear
            ideep_clear = self.ideep_clear
            fpatchy = self._last_fpatchy
        if depth is None:
            raise ValueError(
                'Cannot compute band contributions before run()'
            )
        if getattr(obs, '_band_matrix', None) is None:
            raise ValueError(
                'Undefined observation filters, needed for band '
                'contribution functions'
            )
        if self.rt_path in pc.TRANSMISSION_RT:
            contrib = cfuncs.transmittance(depth, ideep)
            if self.is_patchy and depth_clear is not None:
                contrib_clear = cfuncs.transmittance(
                    depth_clear, ideep_clear,
                )
                contrib = (
                    fpatchy * contrib + (1.0 - fpatchy) * contrib_clear
                )
        else:
            # The reference's stored emission depth is 0 beyond ideep
            # (the C kernel stops at maxdepth and leaves the rest of the
            # column untouched); its CF then vanishes there via the
            # detau > 0.1 discontinuity mask.  Our masked full-depth
            # integration computes real values below ideep, so clamp to
            # the reference semantics before differencing:
            lay = jnp.arange(self.nlayers)[:, None]
            depth_cf = jnp.where(
                lay > jnp.asarray(ideep)[None, :], 0.0, depth,
            )
            contrib = cfuncs.contribution_function(
                depth_cf, self.press, bbody,
            )
        # Raw response x trapezoid weights (the reference's band_cf uses
        # the un-normalized response, not the photon-counting band
        # integration weights; contribution_funcs.py:74-111):
        from .spectrum.passbands import band_cf_matrix
        band_weights = jnp.asarray(
            band_cf_matrix(obs.filters, self.nwave),
        )
        return np.asarray(cfuncs.band_cf(contrib, band_weights))

    def plot_spectrum(self, spec='model', filename=None, obs=None, **kw):
        """Plot the latest (spec='model') or best-fit (spec='best')
        spectrum; reference Pyrat.plot_spectrum (pyrat_obj.py:722-760).
        Returns the matplotlib Axes.
        """
        import matplotlib
        matplotlib.use('Agg')
        from . import plots
        if spec == 'best':
            spectrum = getattr(self, 'spec_best', None)
            if spectrum is None:
                raise ValueError(
                    "plot_spectrum(spec='best') requires a retrieval run"
                )
        else:
            spectrum = self.spectrum
        if spectrum is None:
            raise ValueError('Cannot plot spectrum before run()')
        obs = obs if obs is not None else getattr(self, 'obs', None)
        rt_key = (
            'transit' if self.rt_path in pc.TRANSMISSION_RT else
            'eclipse' if self.rt_path in pc.ECLIPSE_RT else 'emission'
        )
        wl = 1.0 / (np.asarray(self.wn) * pc.um)
        kw.setdefault('rt_path', rt_key)
        if obs is not None and obs.nbands:
            kw.setdefault('band_wl', obs.band_wl)
            kw.setdefault('data', obs.data)
            kw.setdefault('uncert', obs.uncert)
        return plots.spectrum(
            np.asarray(spectrum), wl, filename=filename, **kw,
        )

    def plot_temperature(self, filename=None, **kw):
        """Plot the current temperature profile (reference
        Pyrat.plot_temperature); returns the matplotlib Axes."""
        import matplotlib
        matplotlib.use('Agg')
        from . import plots
        temp = getattr(self, 'temp', None)
        if temp is None:
            temp = np.asarray(self.eval_temp())
        return plots.temperature(
            np.asarray(self.press), profiles=[np.asarray(temp)],
            filename=filename, **kw,
        )

    def __str__(self):
        from .tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('TPU-native radiative-transfer model:')
        fw.write('Run mode (runmode): {}', self.cfg.runmode)
        fw.write('RT path (rt_path): {}', self.rt_path)
        fw.write(
            'Wavenumber range: {:.2f} -- {:.2f} cm-1 ({:d} samples)',
            float(self.wn[0]), float(self.wn[-1]), self.nwave,
        )
        fw.write(
            'Pressure range: {:.2e} -- {:.2e} bar ({:d} layers)',
            float(self.press[0]), float(self.press[-1]), self.nlayers,
        )
        fw.write('Species: {}', [str(s) for s in self.species])
        fw.write('Opacity models:')
        for mtype, model, _ in self.opacity_models:
            tmin = self.tmin.get(mtype)
            bounds = ''
            if tmin is not None:
                bounds = (
                    f'  T = [{self.tmin[mtype]:.1f}, '
                    f'{self.tmax[mtype]:.1f}] K'
                )
            fw.write('  {:22s} ({}){}', model.name, mtype, bounds)
        if self.temp_model is not None:
            fw.write('Temperature model: {}', self.cfg.tmodelname)
        if self.rmodelname is not None:
            fw.write('Radius model: {}', self.rmodelname)
        # System/atmosphere block (the reference's pyrat.atm dump
        # capability, pyrat/atmosphere.py __str__):
        fw.write('System:')
        if self.rplanet is not None:
            fw.write(
                '  Planet radius (rplanet): {:.3f} rjup',
                float(self.rplanet) / pc.rjup,
            )
        if self.mplanet is not None:
            fw.write(
                '  Planet mass (mplanet): {:.3f} mjup',
                float(self.mplanet) / pc.mjup,
            )
        if self.rstar is not None:
            fw.write(
                '  Stellar radius (rstar): {:.3f} rsun',
                float(self.rstar) / pc.rsun,
            )
        if self.tstar is not None:
            fw.write(
                '  Stellar temperature (tstar): {:.1f} K',
                float(self.tstar),
            )
        if self.smaxis is not None:
            fw.write(
                '  Semi-major axis (smaxis): {:.4f} au',
                float(self.smaxis) / pc.au,
            )
        if np.isfinite(self.rhill):
            fw.write(
                '  Hill radius (rhill): {:.3f} rjup',
                float(self.rhill) / pc.rjup,
            )
        # Last-run optical-depth block (the reference's pyrat.od dump
        # capability, pyrat/optic_depth ... objects.py __str__):
        if getattr(self, 'ideep', None) is not None:
            ideep = np.asarray(self.ideep)
            fw.write('Optical depth (last run):')
            fw.write('  Maximum depth to integrate (maxdepth): {:.2f}',
                     float(self.maxdepth))
            fw.write(
                '  ideep range (first layer at maxdepth): '
                '[{:d}, {:d}] of {:d} layers',
                int(ideep.min()), int(ideep.max()), self.nlayers,
            )
        if getattr(self, 'timestamps', None):
            fw.write('Last-run timestamps (s):')
            for key, val in self.timestamps.items():
                fw.write('  {:12s} {:.4f}', key, val)
        return fw.text


def _is_number(val):
    try:
        float(val)
        return True
    except ValueError:
        return False


def _interp_sed(fluxes, temps, tstar):
    """Linear-in-T interpolation of a temperature-gridded stellar SED;
    jnp-compatible (used inside the jitted retrieval forward)."""
    temps = jnp.asarray(temps)
    fluxes = jnp.asarray(fluxes)
    i = jnp.clip(
        jnp.searchsorted(temps, tstar, side='right') - 1,
        0, len(temps) - 2,
    )
    w = (tstar - temps[i]) / (temps[i + 1] - temps[i])
    w = jnp.clip(w, 0.0, 1.0)
    return fluxes[i] * (1.0 - w) + fluxes[i + 1] * w
