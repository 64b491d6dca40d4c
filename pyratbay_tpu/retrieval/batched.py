"""Natively-batched ensemble forward: the retrieval/benchmark hot path.

Semantics match `jax.vmap(build_forward(...))` (pinned by
tests/test_batched.py); the ensemble is assembled explicitly so the
transit RT can run as one fused kernel over the batch:

* the parameter mapping + atmospheric state (small arrays) reuse the
  per-chain `forward.state` under vmap;
* the line-sample temperature interpolation is one flat einsum over
  the ensemble;
* CIA ships as per-chain temperature x density weights against its
  small chain-invariant table, and rank-1 sources (Rayleigh,
  power-law hazes, gray clouds) as per-chain (layer column, wave row)
  pairs -- no dense [B, l, w] buffers for either; genuinely 2-D
  sources (active alkali, H-) vmap as elementwise fusions, and alkali
  lines whose cutoff windows miss the grid are pruned statically;
* transit RT runs through spectrum/ensemble_pallas.py (the Triton
  kernel on a GPU, its XLA reference elsewhere); plane-parallel
  emission/eclipse composes the extinction densely and vmaps the XLA
  solver; band integration is one [B, W] x [W, nbands] product.

Falls back to plain vmap for configurations it does not cover
(two-stream fluxes, live-LBL opacities).
Reference workload: chain-parallel MCMC over pyrat.eval
(pyratbay/pyrat/pyrat_obj.py:225-385, 452-464).
"""
import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as pc
from ..atmosphere import geometry, vmr as vmr_models
from ..ops.planck import blackbody_wn
from ..spectrum import rt
from ..spectrum.ensemble_pallas import (
    dense_extinction, transit_spectrum_ensemble,
)
from .forward import build_forward

__all__ = ['build_forward_batched', 'build_log_posterior_batched']


_BATCHED_RT = (
    pc.TRANSMISSION_RT + ['emission', 'eclipse', 'f_lambda']
)


def _supported(model, obs):
    # Transit + plane-parallel emission/eclipse run the ensemble hot
    # path (incl. the high-res channel: batched convolution + fixed
    # or RV-shifted resampling); two-stream fluxes (layer
    # recurrences) stay on vmap:
    if model.rt_path not in _BATCHED_RT:
        return False
    for mtype, _, _ in model.opacity_models:
        if mtype not in ('line_sample', 'cia', 'alkali', 'rayleigh',
                         'cloud', 'h_ion'):
            return False
    return True


def _two_hot(tlo, w_hi, ntemp):
    """[B, l] lerp indices/weights -> [B, ntemp, l] two-hot weights."""
    t_idx = jnp.arange(ntemp)[None, :, None]
    return (
        (t_idx == tlo[:, None, :]) * (1.0 - w_hi)[:, None, :]
        + (t_idx == tlo[:, None, :] + 1) * w_hi[:, None, :]
    )


def build_forward_batched(model, obs=None, ret=None):
    """Build forward_b(params [B, npars]) -> dict of batched outputs
    (spectrum [B, nwave], bandflux [B, nbands], good [B], temperature).

    Semantics match jax.vmap(build_forward(model, obs, ret)) -- pinned
    by tests/test_batched.py -- with the hot path restructured for
    layout-copy-free ensemble execution.
    """
    forward = build_forward(model, obs, ret)
    if not _supported(model, obs):
        def fallback(params_b):
            return jax.vmap(forward)(params_b)
        fallback.is_fallback = True
        return fallback

    state = forward.state
    nlayers = model.nlayers
    nwave = model.nwave

    tmin_bound = max([model.tmin[k] for k in model.tmin], default=-np.inf)
    tmax_bound = min([model.tmax[k] for k in model.tmax], default=np.inf)
    if ret is not None:
        tmin_bound = max(tmin_bound, ret.tlow)
        tmax_bound = min(tmax_bound, ret.thigh)
    qcap = ret.qcap if ret is not None else None
    rscale = model._radius_scale
    rstar_n = model.rstar / rscale
    maxdepth = model.maxdepth

    rt_path = model.rt_path
    is_transit = rt_path in pc.TRANSMISSION_RT
    is_eclipse = rt_path in pc.ECLIPSE_RT
    wn = np.asarray(model.wn)
    quad_mu = np.asarray(model.quadrature_mu)
    quad_w = np.asarray(model.quadrature_weights)
    starflux = (
        None if model.starflux is None else np.asarray(model.starflux)
    )
    retrieve_tstar = ret is not None and ret.itstar is not None
    sed_temps = getattr(model, 'sed_temps', None)
    sed_fluxes = getattr(model, 'sed_fluxes', None)

    # High-res channel (forward.py:96-110 semantics, batched): the
    # instrumental convolution becomes ONE grouped lax.conv over the
    # ensemble; without a retrieved RV the resampling at wn_hires is a
    # fixed two-point lerp (precomputed gather indices), with RV it is
    # a per-chain jnp.interp on the Doppler-shifted grid:
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
        retrieve_rv = ret is not None and ret.irv is not None
        if not retrieve_rv:
            # Fixed-grid lerp indices (same math as jnp.interp on an
            # increasing wn grid, incl. edge clamping):
            hires_ilo = np.clip(
                np.searchsorted(wn, wn_hires, side='right') - 1,
                0, nwave - 2,
            )
            hires_whi = np.clip(
                (wn_hires - wn[hires_ilo])
                / (wn[hires_ilo + 1] - wn[hires_ilo]), 0., 1.,
            )

    def forward_b(params_b):
        params_b = jnp.asarray(params_b)
        st = jax.vmap(state)(params_b)
        temp = st['temp']                  # [B, l]
        dens = st['dens']                  # [B, l, nmol]
        radius = st['radius']              # [B, l]
        rtop = st['rtop']                  # [B]
        pars_list = st['pars_list']
        fpatchy = st['fpatchy']
        nb = params_b.shape[0]

        # Extinction stays in the RT kernel's operand classes: dense
        # [B, l, w] parts (the line-sample contraction; elementwise
        # sources share one accumulator), rank-1 (layer column, wave
        # row) pairs, and CIA weights against the chain-invariant
        # table.  The XLA path composes them densely.
        parts = []
        r1_col_list = []
        r1_row_list = []
        cloud_parts = []
        cia_ws = []
        cia_tabs = []
        elem = None
        deck_itop = deck_rsurf = deck_tsurf = None
        have_deck = False

        for (mtype, m, imol), pars in zip(
                model.opacity_models, pars_list):
            if m.name == 'deck':
                surf = jax.vmap(m.surface)(radius, temp, pars)
                deck_itop, deck_rsurf, deck_tsurf = surf
                have_deck = True
                continue

            if mtype == 'line_sample':
                tlo, w_hi = jax.vmap(m._t_weights)(temp)
                w_t = _two_hot(tlo, w_hi, m.ntemp)      # [B, t, l]
                ratios = (
                    jax.vmap(m._jit_ratios)(pars)
                    if pars is not None and m.npars
                    else jnp.broadcast_to(
                        jnp.asarray(m.iso_ratios), (nb, m.nspec))
                )                                       # [B, s]
                d_w = (
                    jnp.swapaxes(dens[:, :, jnp.asarray(imol)], 1, 2)
                    * ratios[:, :, None]
                )                                       # [B, s, l]
                w_stl = w_t[:, None] * d_w[:, :, None]  # [B, s, t, l]
                parts.append(jnp.einsum(
                    'bstl,stlw->blw', w_stl, jnp.asarray(m.cs_table),
                    precision=jax.lax.Precision.HIGHEST,
                ))
                continue
            if mtype == 'cia':
                tcl = jnp.clip(temp, m.tmin, m.tmax)
                temps = jnp.asarray(m.temps)
                tlo = jnp.clip(
                    jnp.searchsorted(temps, tcl, side='right') - 1,
                    0, m.ntemp - 2,
                )
                w_hi = (tcl - temps[tlo]) / (temps[tlo + 1] - temps[tlo])
                w_t = _two_hot(tlo, w_hi, m.ntemp)      # [B, t, l]
                dens_am = dens[:, :, jnp.asarray(imol)] / pc.amagat
                dprod = jnp.prod(dens_am, axis=2)       # [B, l]
                cia_ws.append(
                    jnp.swapaxes(w_t * dprod[:, None, :], 1, 2),
                )                                       # [B, l, t]
                cia_tabs.append(np.asarray(m.tab_cs_amagat))
                continue
            if mtype == 'rayleigh':
                col, row = jax.vmap(m.ec_rank1)(dens[:, :, imol])
                r1_col_list.append(col)
                r1_row_list.append(jnp.broadcast_to(row, (nb, nwave)))
                continue
            if mtype == 'cloud' and not model.is_patchy \
                    and hasattr(m, 'ec_rank1'):
                col, row = jax.vmap(m.ec_rank1)(temp, pars)
                r1_col_list.append(col)
                r1_row_list.append(jnp.broadcast_to(row, (nb, nwave)))
                continue

            if mtype == 'alkali':
                if not getattr(m, 'active_lines', True):
                    # Every line's cutoff window is off this grid:
                    # the contribution is exactly zero.
                    continue
                contrib = jax.vmap(m.extinction)(temp, dens[:, :, imol])
            elif mtype == 'cloud':
                contrib = jax.vmap(m.extinction)(temp, pars)
            elif mtype == 'h_ion':
                contrib = jax.vmap(m.extinction)(
                    temp, dens[:, :, imol[0]], dens[:, :, imol[1]],
                )
            else:  # pragma: no cover -- _supported() gates this
                raise ValueError(f'Unsupported opacity type {mtype}')

            if mtype == 'cloud':
                cloud_parts.append(contrib)
            else:
                elem = contrib if elem is None else elem + contrib
        if elem is not None:
            parts.append(elem)
        if len(cloud_parts) > 1:
            cloud_sum = cloud_parts[0]
            for extra_cloud in cloud_parts[1:]:
                cloud_sum = cloud_sum + extra_cloud
            cloud_parts = [cloud_sum]

        r1_cols = r1_rows = None
        if r1_col_list:
            r1_cols = jnp.stack(r1_col_list, axis=1)    # [B, r, l]
            r1_rows = jnp.stack(r1_row_list, axis=1)    # [B, r, w]
        cia_w = cia_tab = None
        if cia_ws:
            cia_w = jnp.concatenate(cia_ws, axis=2)     # [B, l, K]
            cia_tab = np.concatenate(cia_tabs, axis=0)  # [K, w]
        if not (parts or cloud_parts or r1_col_list or cia_ws):
            parts = [jnp.zeros((nb, nlayers, nwave))]

        # ---- RT (batched):
        if have_deck:
            ibottom = deck_itop + 1
        else:
            ibottom = jnp.full((nb,), nlayers)

        if is_transit:
            rr = radius / rscale
            path = jax.vmap(geometry.transit_path_matrix)(
                rr, rtop) * rscale
            deck_surf = deck_rsurf / rscale if have_deck else None

            def run_rt(ec_parts, ibot, ditop, dsurf):
                return transit_spectrum_ensemble(
                    ec_parts, path, rr, rstar_n, rtop, ibot,
                    deck_itop=ditop, deck_rsurf=dsurf,
                    cia_w=cia_w, cia_tab=cia_tab,
                    r1_cols=r1_cols, r1_rows=r1_rows,
                    maxdepth=maxdepth,
                )
        else:
            wn_j = jnp.asarray(wn)
            mu_j = jnp.asarray(quad_mu)
            w_col = jnp.asarray(quad_w)[:, None]

            def espec_one(ec_i, rad_i, temp_i, rtop_i, ibot_i, dit, dts):
                depth, ideep = rt.plane_parallel_depth(
                    ec_i, rad_i, maxdepth, rtop_i, ibot_i,
                )
                bbody = blackbody_wn(wn_j, temp_i[:, None])
                if dts is not None:
                    bb_surf = blackbody_wn(wn_j, dts)
                    bbody = jnp.where(
                        (jnp.arange(nlayers) == dit)[:, None],
                        bb_surf[None, :], bbody,
                    )
                    ideep = jnp.clip(ideep, 0, dit)
                inten = rt.plane_parallel_intensity(
                    depth, bbody, mu_j, ideep, rtop_i,
                )
                return jnp.sum(inten * w_col, axis=0)

            def run_rt(ec_parts, ibot, ditop, dtsurf):
                ec = dense_extinction(
                    ec_parts, cia_w, cia_tab, r1_cols, r1_rows)
                deck_axis = None if ditop is None else 0
                return jax.vmap(
                    espec_one,
                    in_axes=(0, 0, 0, 0, 0, deck_axis, deck_axis),
                )(ec, radius, temp, rtop, ibot, ditop, dtsurf)

            deck_surf = deck_tsurf
        spectrum = run_rt(parts + cloud_parts, ibottom, deck_itop, deck_surf)
        if model.is_patchy:
            clear = run_rt(parts, jnp.full((nb,), nlayers), None, None)
            fp = fpatchy if fpatchy is not None else 0.0
            spectrum = fp[:, None] * spectrum + (1 - fp[:, None]) * clear

        # ---- Emission post-scalings (forward.py:250-274 semantics):
        if not is_transit:
            fd = st['f_dilution']
            if fd is not None:
                fd = jnp.asarray(fd)
                spectrum = spectrum * (
                    fd[:, None] if fd.ndim == 1 else fd
                )
            rp = jnp.asarray(st['rplanet'])
            rp_col = rp[:, None] if rp.ndim == 1 else rp
            if is_eclipse:
                if retrieve_tstar and sed_temps is not None:
                    from ..model import _interp_sed
                    sflux = jax.vmap(
                        lambda ts: _interp_sed(
                            sed_fluxes, sed_temps, ts),
                    )(st['tstar'])
                elif retrieve_tstar:
                    sflux = jax.vmap(
                        lambda ts: blackbody_wn(
                            jnp.asarray(wn), ts) * np.pi,
                    )(st['tstar'])
                else:
                    sflux = jnp.asarray(starflux)[None, :]
                spectrum = (
                    spectrum / sflux * (rp_col / model.rstar)**2
                )
            if rt_path == 'f_lambda':
                if model.distance is None:
                    raise ValueError(
                        'Undefined distance to the system, required '
                        'for f_lambda flux'
                    )
                spectrum = (
                    10.0 * spectrum
                    * (rp_col / model.distance
                       * jnp.asarray(wn)[None, :] * pc.um)**2
                )

        # ---- Rejection + band integration:
        good = (
            (jnp.min(temp, axis=1) >= tmin_bound)
            & (jnp.max(temp, axis=1) <= tmax_bound)
            & (jnp.min(temp, axis=1) > 0)
        )
        if qcap is not None and model.ibulk is not None:
            good = good & ~jax.vmap(
                lambda v: vmr_models.qcapcheck(
                    v, qcap, np.asarray(model.ibulk)),
            )(st['vmr'])
        spectrum = jnp.where(good[:, None], spectrum, 0.0)

        out = {
            'spectrum': spectrum,
            'temperature': temp,
            'good': good,
        }
        if obs is not None and obs.nbands:
            bandflux = jax.vmap(obs.band_integrate)(spectrum)
            out['bandflux'] = jnp.where(
                good[:, None], bandflux, jnp.inf,
            )
        if has_hires:
            krev = jnp.asarray(
                np.ascontiguousarray(hires_kernel[::-1]),
            ).astype(spectrum.dtype)
            kw = hires_kernel.shape[0]
            pad_lo = kw - 1 - (kw - 1) // 2
            conv = jax.lax.conv_general_dilated(
                spectrum[:, None, :], krev[None, None, :],
                window_strides=(1,),
                padding=[(pad_lo, (kw - 1) // 2)],
                dimension_numbers=('NCH', 'OIH', 'NCH'),
            )[:, 0, :]
            if retrieve_rv:
                vel = params_b[:, ret.irv] * pc.km
                factor = jnp.sqrt(
                    (1.0 - vel / pc.c) / (1.0 + vel / pc.c))
                wn_j = jnp.asarray(wn)
                wh = jnp.asarray(wn_hires)
                flux_hires = jax.vmap(
                    lambda f, c_row: jnp.interp(wh, wn_j * f, c_row),
                )(factor, conv)
            else:
                flux_hires = (
                    conv[:, hires_ilo] * (1.0 - hires_whi)
                    + conv[:, hires_ilo + 1] * hires_whi
                )
            out['bandflux_hires'] = jnp.where(
                good[:, None], flux_hires, jnp.inf,
            )
        return out

    forward_b.is_fallback = False
    return forward_b


def build_log_posterior_batched(model, obs, ret):
    """Batched params [B, n] -> log-posterior [B] on the ensemble hot
    path (same math as vmap(build_log_posterior(...)))."""
    from .forward import build_log_posterior

    forward_b = build_forward_batched(model, obs, ret)
    has_lowres = obs.data is not None and obs.nbands > 0
    has_hires_data = getattr(obs, 'data_hires', None) is not None
    if forward_b.is_fallback or not (has_lowres or has_hires_data):
        # The fallback also owns the no-data case: build_log_posterior
        # raises the descriptive data/obsfile ValueError instead of an
        # opaque asarray(None) failure here.
        log_post = build_log_posterior(model, obs, ret)
        return jax.vmap(log_post)

    if has_lowres:
        data = jnp.asarray(obs.data)
        uncert = jnp.asarray(obs.uncert)
    if has_hires_data:
        data_hires = jnp.asarray(obs.data_hires)
        uncert_hires = jnp.asarray(obs.uncert_hires)
    pmin = jnp.asarray(ret.pmin)
    pmax = jnp.asarray(ret.pmax)
    prior = jnp.asarray(ret.prior)
    priorlow = jnp.asarray(ret.priorlow)
    priorup = jnp.asarray(ret.priorup)
    has_prior = jnp.asarray(ret.priorlow > 0)

    def log_post_b(params_b):
        params_b = jnp.asarray(params_b)
        result = forward_b(params_b)
        log_like = 0.0
        if has_lowres:
            bandflux = result['bandflux']
            data_adj = data[None, :]
            uncert_adj = uncert[None, :]
            log_norm = 0.0
            if ret.ioffset:
                data_adj = jax.vmap(obs.offset_data)(
                    params_b[:, jnp.asarray(ret.ioffset)],
                )
            if ret.ierror:
                uncert_adj = jax.vmap(obs.scale_uncert)(
                    params_b[:, jnp.asarray(ret.ierror)],
                )
                log_norm = -jnp.sum(
                    jnp.log(uncert_adj / uncert[None, :]), axis=1,
                )
            resid = (bandflux - data_adj) / uncert_adj
            log_like = -0.5 * jnp.sum(resid**2, axis=1) + log_norm
        if has_hires_data:
            resid_h = (
                result['bandflux_hires'] - data_hires[None, :]
            ) / uncert_hires[None, :]
            log_like = log_like - 0.5 * jnp.sum(resid_h**2, axis=1)
        in_bounds = jnp.all(
            (params_b >= pmin[None]) & (params_b <= pmax[None]), axis=1,
        )
        sigma = jnp.where(params_b > prior[None], priorup[None],
                          priorlow[None])
        log_prior = -0.5 * jnp.sum(jnp.where(
            has_prior[None],
            ((params_b - prior[None]) / jnp.where(
                sigma > 0, sigma, 1.0))**2,
            0.0,
        ), axis=1)
        logp = log_like + log_prior
        bad = ~in_bounds | ~result['good'] | ~jnp.isfinite(log_like)
        return jnp.where(bad, -jnp.inf, logp)

    return log_post_b
