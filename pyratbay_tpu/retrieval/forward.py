"""Jit-compiled retrieval forward model: params -> (spectrum, bandflux).

The whole evaluation -- parameter mapping, T/VMR/radius profiles,
opacities, RT, band integration, and rejection logic -- is one pure JAX
function: jit it for a single evaluation, vmap it over an ensemble of
chains, shard_map it over a device mesh.  This replaces the reference's
process-per-chain eval loop (pyratbay/pyrat/pyrat_obj.py:225-385).

Out-of-bounds states (temperature limits, opacity-table bounds, VMR
caps) zero the spectrum and set bandflux to +inf so samplers reject the
step, exactly mirroring the reference's semantics but without host
round trips.
"""
import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as pc
from ..atmosphere import geometry, hydro, vmr as vmr_models
from ..ops.planck import blackbody_wn
from ..spectrum import rt

__all__ = ['build_forward', 'build_log_posterior']


def build_forward(model, obs=None, ret=None, dtype=None):
    """Build the pure forward function for a configured model.

    Parameters
    ----------
    model: Model -- static setup (grids, tables, opacity models).
    obs: Observation or None -- band matrix for bandflux output.
    ret: RetrievalParams or None -- parameter-to-slot maps.  If None,
        the function takes no parameters and evaluates the config state.

    Returns
    -------
    forward(params) -> dict(spectrum, bandflux, temperature, good)
    """
    # Live line-by-line opacity runs through the jit-safe DirectLBL
    # engine (exact Voigt, core/wing split); instantiate it eagerly so
    # its device tables upload once, before tracing:
    has_lbl = any(mtype == 'lbl' for mtype, _, _ in model.opacity_models)
    if has_lbl:
        for mtype, m, _ in model.opacity_models:
            if mtype == 'lbl':
                model.direct_lbl(m)

    # Closures hold host numpy arrays: they are embedded as constants
    # at trace time, so building the forward dispatches no eager device
    # ops.
    nlayers = model.nlayers
    press = np.asarray(model.press)
    mol_mass = np.asarray(model.mol_mass)
    base_vmr = np.asarray(model.base_vmr)
    base_temp = (
        None if model.base_temp is None else np.asarray(model.base_temp)
    )
    temp_model = model.temp_model
    base_tpars = (
        None if model.tpars is None else np.asarray(model.tpars)
    )
    rt_path = model.rt_path
    is_transit = rt_path in pc.TRANSMISSION_RT
    is_eclipse = rt_path in pc.ECLIPSE_RT
    two_stream = 'two_stream' in rt_path

    # Static bounds for rejection:
    tmin_bound = max([model.tmin[k] for k in model.tmin], default=-np.inf)
    tmax_bound = min([model.tmax[k] for k in model.tmax], default=np.inf)
    if ret is not None:
        tmin_bound = max(tmin_bound, ret.tlow)
        tmax_bound = min(tmax_bound, ret.thigh)
    qcap = ret.qcap if ret is not None else None

    base_pars = [
        np.array(m.pars, float)
        if getattr(m, 'npars', 0) > 0 else None
        for _, m, _ in model.opacity_models
    ]
    base_vmr_pars = model.vmr_pars
    runits = pc.u(model.cfg.runits or 'rjup')
    mass_units = pc.u(model.cfg.mass_units or 'mjup')
    quadrature_mu = np.asarray(model.quadrature_mu)
    quadrature_w = np.asarray(model.quadrature_weights)[:, None]
    starflux = (
        None if model.starflux is None else np.asarray(model.starflux)
    )
    wn = np.asarray(model.wn)

    # High-resolution channel: a static instrumental kernel (computed
    # from inst_resolution and the model grid's sampling resolution)
    # convolves the spectrum; an optional retrieved RV shifts the
    # wavenumber grid before interpolating at the data wavenumbers
    # (reference pyrat/pyrat_obj.py:331-356, jit-safe throughout):
    has_hires = (
        obs is not None and getattr(obs, 'wn_hires', None) is not None
    )
    if has_hires:
        from ..spectrum.hires import instrumental_kernel
        sampling_res = model.grid.resolution
        if sampling_res is None:
            dwn = np.ediff1d(wn)
            sampling_res = float(np.median(wn[:-1] / dwn))
        hires_kernel = np.asarray(instrumental_kernel(
            obs.inst_resolution, sampling_res,
        ))
        wn_hires = np.asarray(obs.wn_hires)

    # Retrieving tstar requires a T-dependent stellar flux: either a
    # temperature-gridded SED (interpolated, reference
    # pyrat/pyrat_obj.py:288-290) or a blackbody star:
    retrieve_tstar = ret is not None and ret.itstar is not None
    sed_temps = getattr(model, 'sed_temps', None)
    sed_fluxes = getattr(model, 'sed_fluxes', None)
    if retrieve_tstar and is_eclipse and sed_temps is None \
            and not getattr(model, 'star_is_blackbody', True):
        raise ValueError(
            'Cannot retrieve tstar from a fixed input stellar spectrum; '
            'provide a temperature-gridded SED file (starspec with '
            '@TEMPERATURES) or a blackbody star (tstar alone)'
        )

    def state(params=None):
        """Parameter mapping + atmospheric state: everything upstream
        of the opacity/RT stage, as a pytree (the batched ensemble
        builder vmaps this part and assembles opacities itself --
        retrieval/batched.py)."""
        # ---- Map parameters onto model slots:
        tpars = base_tpars
        vmr_par_list = base_vmr_pars
        pars_list = list(base_pars)
        rplanet = model.rplanet
        mplanet = model.mplanet
        refpress = model.refpressure
        fpatchy = model.fpatchy
        f_dilution = model.cfg.f_dilution
        tstar = model.tstar

        if ret is not None and params is not None:
            params = jnp.asarray(params)
            if ret.itemp:
                tp = jnp.asarray(
                    base_tpars if base_tpars is not None
                    else np.zeros(len(ret.map_temp))
                )
                tpars = tp.at[jnp.asarray(ret.map_temp)].set(
                    params[jnp.asarray(ret.itemp)],
                )
            if ret.imol:
                vmr_par_list = [None] * len(model.vmr_var_names)
                if base_vmr_pars is not None:
                    vmr_par_list = list(base_vmr_pars)
                for i_par, slot in zip(ret.imol, ret.map_mol):
                    vmr_par_list[slot] = params[i_par]
            for j, (idx, slots) in enumerate(
                    zip(ret.iopacity, ret.map_opacity)):
                if not idx:
                    continue
                pars = jnp.asarray(pars_list[j])
                pars = pars.at[jnp.asarray(slots)].set(
                    params[jnp.asarray(idx)],
                )
                pars_list[j] = pars
            if ret.irad is not None:
                rplanet = params[ret.irad] * runits
            if ret.imass is not None:
                mplanet = params[ret.imass] * mass_units
            if ret.ipress is not None:
                refpress = 10.0 ** params[ret.ipress]
            if ret.ipatchy is not None:
                fpatchy = params[ret.ipatchy]
            if ret.idilut is not None:
                f_dilution = params[ret.idilut]
            if ret.itstar is not None:
                tstar = params[ret.itstar]

        # ---- Atmospheric state:
        if tpars is not None and temp_model is not None:
            temp = temp_model(tpars)
        else:
            temp = base_temp

        # Free, equilibrium-chemistry, and hybrid VMR models share the
        # Model's jit-pure evaluator:
        vmr = model._eval_vmr_pure(vmr_par_list, temp)

        dens = hydro.ideal_gas_density(vmr, press, temp)
        mm = hydro.mean_weight(vmr, mol_mass)
        if model.rmodelname == 'hydro_m':
            radius = hydro.hydro_m(
                press, temp, mm, mplanet, refpress, rplanet,
            )
        elif model.rmodelname == 'hydro_g':
            gplanet = pc.G * mplanet / rplanet**2
            radius = hydro.hydro_g(
                press, temp, mm, gplanet, refpress, rplanet,
            )
        elif model.input_radius is not None:
            radius = jnp.asarray(model.input_radius)
        else:
            radius = None

        rtop = 0
        if radius is not None and np.isfinite(model.rhill):
            inside = radius < model.rhill
            rtop = jnp.where(jnp.any(inside), jnp.argmax(inside), 0)

        return {
            'params': params, 'tpars': tpars,
            'vmr_par_list': vmr_par_list, 'pars_list': pars_list,
            'rplanet': rplanet, 'mplanet': mplanet,
            'refpress': refpress, 'fpatchy': fpatchy,
            'f_dilution': f_dilution, 'tstar': tstar,
            'temp': temp, 'vmr': vmr, 'dens': dens, 'mm': mm,
            'radius': radius, 'rtop': rtop,
        }

    def forward(params=None):
        st = state(params)
        params = st['params']
        tpars = st['tpars']
        pars_list = st['pars_list']
        rplanet = st['rplanet']
        mplanet = st['mplanet']
        fpatchy = st['fpatchy']
        f_dilution = st['f_dilution']
        tstar = st['tstar']
        temp = st['temp']
        vmr = st['vmr']
        dens = st['dens']
        radius = st['radius']
        rtop = st['rtop']

        # ---- Opacity + RT (reuses the Model's jit-safe pipeline):
        ec, ec_cloud, deck_surface = model.extinction(
            temp, radius, dens, pars_list,
            lbl_engine='direct' if has_lbl else 'parity',
        )
        if is_transit:
            result = model._run_transit(
                ec, ec_cloud, deck_surface, radius, rtop, fpatchy,
            )
        else:
            result = model._run_emission(
                ec, ec_cloud, deck_surface, temp, radius, rtop, fpatchy,
            )
        spectrum = result['spectrum']

        if not is_transit and f_dilution is not None:
            spectrum = spectrum * f_dilution
        if is_eclipse:
            if retrieve_tstar and sed_temps is not None:
                from ..model import _interp_sed
                sflux = _interp_sed(sed_fluxes, sed_temps, tstar)
            elif retrieve_tstar:
                sflux = blackbody_wn(wn, tstar) * np.pi
            else:
                sflux = starflux
            spectrum = spectrum / sflux * (rplanet / model.rstar)**2
        if rt_path == 'f_lambda':
            # Flux observed at Earth in W m-2 um-1 (reference
            # pyrat_obj.py:325-330): 10x converts
            # erg s-1 cm-2 cm -> W m-2 um-1 after the (wn um)^2
            # wavelength-unit Jacobian:
            if model.distance is None:
                raise ValueError(
                    'Undefined distance to the system, required for '
                    'f_lambda flux'
                )
            spectrum = (
                10.0 * spectrum
                * (rplanet / model.distance * jnp.asarray(wn) * pc.um)**2
            )

        # ---- Rejection logic:
        good = (
            (jnp.min(temp) >= tmin_bound)
            & (jnp.max(temp) <= tmax_bound)
            & (jnp.min(temp) > 0)
        )
        if qcap is not None and model.ibulk is not None:
            good = good & ~vmr_models.qcapcheck(
                vmr, qcap, np.asarray(model.ibulk),
            )
        spectrum = jnp.where(good, spectrum, 0.0)

        out = {
            'spectrum': spectrum,
            'temperature': temp,
            'good': good,
            # RT diagnostics: enough state to compute contribution
            # functions / transmittances post-run (the reference's
            # band_contribution inputs, pyrat_obj.py:671-696).  Unused
            # outputs are dead-code-eliminated from the retrieval hot
            # path's own jit trace.
            'depth': result['depth'],
            'ideep': result['ideep'],
            'fpatchy': (
                fpatchy if fpatchy is not None else jnp.asarray(1.0)
            ),
        }
        for key in ('bbody', 'depth_clear', 'ideep_clear',
                    'clear', 'cloudy'):
            if key in result:
                out[key] = result[key]
        if obs is not None and obs.nbands:
            bandflux = obs.band_integrate(spectrum)
            bandflux = jnp.where(good, bandflux, jnp.inf)
            out['bandflux'] = bandflux
        if has_hires:
            conv = jnp.convolve(
                spectrum, jnp.asarray(hires_kernel), mode='same',
            )
            wn_eval = jnp.asarray(wn)
            if ret is not None and ret.irv is not None:
                vel = params[ret.irv] * pc.km
                wn_eval = wn_eval * jnp.sqrt(
                    (1.0 - vel / pc.c) / (1.0 + vel / pc.c)
                )
            flux_hires = jnp.interp(
                jnp.asarray(wn_hires), wn_eval, conv,
            )
            out['bandflux_hires'] = jnp.where(
                good, flux_hires, jnp.inf,
            )
        return out

    forward.state = state
    return forward


def build_log_posterior(model, obs, ret):
    """Gaussian log-posterior over band-integrated data.

    Returns a pure function params -> scalar log-posterior (suitable
    for jit/vmap/grad), combining the data likelihood, uniform bounds,
    and optional Gaussian priors.
    """
    forward = build_forward(model, obs, ret)
    has_lowres = obs.data is not None and obs.nbands > 0
    if has_lowres:
        data = jnp.asarray(obs.data)
        uncert = jnp.asarray(obs.uncert)
    has_hires_data = getattr(obs, 'data_hires', None) is not None
    if has_hires_data:
        data_hires = jnp.asarray(obs.data_hires)
        uncert_hires = jnp.asarray(obs.uncert_hires)
    if not has_lowres and not has_hires_data:
        raise ValueError(
            'Undefined observed data (data/obsfile/obsfile_hires), '
            'required to build the likelihood'
        )
    pmin = jnp.asarray(ret.pmin)
    pmax = jnp.asarray(ret.pmax)
    prior = jnp.asarray(ret.prior)
    priorlow = jnp.asarray(ret.priorlow)
    priorup = jnp.asarray(ret.priorup)
    has_prior = jnp.asarray(ret.priorlow > 0)

    def log_post(params):
        params = jnp.asarray(params)
        result = forward(params)
        log_like = 0.0
        if has_lowres:
            bandflux = result['bandflux']
            # Instrumental offsets shift the data; error-scaling
            # inflates the uncertainties (with the chi2 normalization
            # term):
            data_adj = data
            uncert_adj = uncert
            if ret.ioffset:
                data_adj = obs.offset_data(
                    params[jnp.asarray(ret.ioffset)],
                )
            log_norm = 0.0
            if ret.ierror:
                uncert_adj = obs.scale_uncert(
                    params[jnp.asarray(ret.ierror)],
                )
                log_norm = -jnp.sum(jnp.log(uncert_adj / uncert))
            resid = (bandflux - data_adj) / uncert_adj
            log_like = -0.5 * jnp.sum(resid**2) + log_norm
        if has_hires_data:
            # Mixed low-res + high-res likelihood (the reference
            # returns one or the other; combining is a TODO there,
            # pyrat_obj.py:352-354):
            resid_h = (
                result['bandflux_hires'] - data_hires
            ) / uncert_hires
            log_like = log_like - 0.5 * jnp.sum(resid_h**2)
        in_bounds = jnp.all((params >= pmin) & (params <= pmax))
        # Two-sided Gaussian priors where defined:
        sigma = jnp.where(params > prior, priorup, priorlow)
        log_prior = -0.5 * jnp.sum(jnp.where(
            has_prior, ((params - prior) / jnp.where(
                sigma > 0, sigma, 1.0))**2, 0.0,
        ))
        logp = log_like + log_prior
        bad = (
            ~in_bounds | ~result['good']
            | ~jnp.isfinite(log_like)
        )
        return jnp.where(bad, -jnp.inf, logp)

    return log_post
