"""Radiative(-convective) equilibrium: iterate the two-stream fluxes to
a steady temperature profile.

Two execution paths around the same jitted two-stream step (reference
pyratbay/spectrum/radiative_transfer.py:141-274):

* **Device scan** (default for pure-radiative runs): the whole
  adaptive loop -- wobble-damped temperature updates, scipy-exact
  gaussian smoothing, clipping -- runs as one `lax.scan` on device.
  The reference pays a full host round trip per iteration (chemcat +
  numpy update); the scan pays one per 25-iteration chunk.
* **Host loop** (convective runs): the convective-flux redo is
  data-dependent control flow, so it stays in numpy around the jitted
  step.

Both paths implement identical arithmetic (including the reference's
warm-restart quirk where the sign history restarts as zeros and
triggers a wobble halving); tests pin scan == host at float64
round-off and the trajectory against the live reference.
"""
import numpy as np
from scipy.ndimage import gaussian_filter1d

from .. import constants as pc
from .convection import convective_flux

__all__ = ['radiative_equilibrium']

_MAXF = 1.0e8  # maximum temperature scale factor


def _gauss_kernel_scipy(sigma, radius, xp):
    """Gaussian kernel weights over [-radius, radius], truncated and
    normalized exactly as scipy.ndimage.gaussian_filter1d with
    truncate=4.0: support floor(4*sigma + 0.5), zero beyond."""
    x = xp.arange(-radius, radius + 1)
    w = xp.exp(-0.5 * (x / sigma) ** 2)
    w = xp.where(xp.abs(x) <= xp.floor(4.0 * sigma + 0.5), w, 0.0)
    return w / xp.sum(w)


def _gauss_filter_reflect(y, sigma, radius, xp):
    """scipy gaussian_filter1d (mode='reflect') with a static support
    radius and a possibly-traced sigma.  Requires len(y) > radius (the
    edge reflection only covers one mirror period)."""
    if y.shape[0] <= radius:
        raise ValueError(
            f'gaussian smoothing needs more than {radius} layers '
            f'(got {y.shape[0]}); use use_scan=False for very small '
            'layer grids'
        )
    w = _gauss_kernel_scipy(sigma, radius, xp)
    ypad = xp.concatenate([y[radius - 1::-1], y, y[:-radius - 1:-1]])
    if xp is np:
        return np.convolve(ypad, w, mode='valid')
    import jax.numpy as jnp
    return jnp.convolve(ypad, w, mode='valid')


def _radeq_scan_runner(model):
    """The jitted chunked-scan runner for this model, compiled once and
    cached on the model instance (a fresh jax.jit wrapper per call would
    re-trace the full RT program every time; library users without the
    persistent compilation cache would pay seconds per warm restart).

    Everything that can change between calls (temperatures, scale
    state, opacity/VMR parameters, grids, tmin/tmax) is a traced
    argument; only the model's *structure* (which opacity models and
    RT path exist) is baked in, and that is fixed per instance.
    """
    runner = getattr(model, '_radeq_scan_cache', None)
    if runner is not None:
        return runner

    import jax
    import jax.numpy as jnp
    from functools import partial
    from ..atmosphere import hydro

    @partial(jax.jit, static_argnames='length')
    def run_scan(carry0, consts, length):
        (press, wn_j, dpress_j, base_vmr, mol_mass, pars_list,
         vmr_pars, tmin, tmax, fpatchy) = consts

        def step(temp):
            # Equilibrium chemistry re-solves composition at the
            # current T(p) every iteration, inside the same jitted
            # step (reference host-calls chemcat per iteration,
            # spectrum/radiative_transfer.py:202):
            if model.chem_model is not None:
                vmr_k = model._eval_vmr_pure(vmr_pars, temp)
            else:
                vmr_k = base_vmr
            dens = hydro.ideal_gas_density(vmr_k, press, temp)
            mm = hydro.mean_weight(vmr_k, mol_mass)
            radius = model.eval_radius(temp, mm)
            ec, ec_cloud, deck_surface = model.extinction(
                temp, radius, dens, pars_list,
            )
            result = model._run_emission(
                ec, ec_cloud, deck_surface, temp, radius, 0, fpatchy,
            )
            return result['flux_up'], result['flux_down']

        def scan_body(carry, _):
            temp, scale, buf, valid = carry
            flux_up, flux_down = step(temp)
            q_net = (
                jnp.trapezoid(flux_up, wn_j, axis=1)
                - jnp.trapezoid(flux_down, wn_j, axis=1)
            )
            diff_flux = jnp.concatenate(
                [jnp.zeros(1), jnp.diff(q_net)])
            sign_k = jnp.sign(diff_flux)
            wobble = jnp.any(
                valid[:, None] & (buf != sign_k[None, :]), axis=0,
            )
            scale = jnp.where(wobble, scale * 0.5, scale * 1.15)
            scale = _gauss_filter_reflect(
                jnp.clip(scale, 1.0, _MAXF), 1.5, 6, jnp,
            )
            dt = (
                scale * sign_k * jnp.abs(diff_flux) ** 0.1
                / (pc.sigma_sb * temp ** 3 * dpress_j)
            )
            t1 = temp + dt
            t1 = t1.at[0].set(t1[1])
            sigma = jnp.clip(jnp.mean(jnp.abs(dt)) / 10.0, 0.75, 2.0)
            smoothed = _gauss_filter_reflect(t1, sigma, 8, jnp)
            t1 = jnp.concatenate([smoothed[:-1], t1[-1:]])
            t1 = jnp.clip(t1, tmin, tmax)
            buf = jnp.concatenate([buf[1:], sign_k[None, :]])
            valid = jnp.concatenate(
                [valid[1:], jnp.ones(1, bool)])
            return (t1, scale, buf, valid), t1

        return jax.lax.scan(scan_body, carry0, None, length=length)

    model._radeq_scan_cache = run_scan
    return run_scan


def radiative_equilibrium(
        model, nsamples=100, convection=False, tmin=0.0, tmax=6000.0,
        radeq_temps=None, dt_scale=None, use_scan=None,
    ):
    """Iterate toward radiative equilibrium.

    Parameters
    ----------
    model: Model with an emission_two_stream rt_path.
    nsamples: number of iterations (100-300 typically suffice).
    convection: include mixing-length convective-flux transport.
    radeq_temps/dt_scale: warm-restart state from a previous call
        (reference continue_run semantics, pyrat_obj.py:604-611).
    use_scan: run the whole loop as one device lax.scan (default: yes
        unless convection is requested -- see module docstring).

    Returns
    -------
    radeq_temps: [niter, nlayers] temperature profiles per iteration
        (also stored on model.radeq_temps).
    """
    import jax
    import jax.numpy as jnp
    from ..atmosphere import hydro

    if 'two_stream' not in model.rt_path:
        raise ValueError(
            "Radiative equilibrium requires rt_path = "
            "'emission_two_stream'"
        )
    nlayers = model.nlayers
    press = np.asarray(model.press)
    wn = np.asarray(model.wn)
    vmr = np.asarray(model.base_vmr)
    mol_mass = np.asarray(model.mol_mass)

    if radeq_temps is None:
        temp0 = np.asarray(model.eval_temp())
        radeq_temps = np.atleast_2d(temp0)
    n_prev = len(radeq_temps)
    temps = np.vstack([radeq_temps, np.zeros((nsamples, nlayers))])
    if dt_scale is None:
        # Reference initial temperature scale factor
        # (pyrat_obj.py:604-605):
        dt_scale = np.tile(1.0e5, nlayers)

    # Host-loop two-stream step, compiled once per model (same caching
    # rationale as _radeq_scan_runner):
    step_jit = getattr(model, '_radeq_step_cache', None)
    if step_jit is None:
        def _step(temp, press_j, base_vmr, mol_mass_j, pars_list,
                  vmr_pars, fpatchy):
            # Equilibrium chemistry re-solves composition at the
            # current T(p) every iteration, inside the same jitted
            # step (reference host-calls chemcat per iteration,
            # spectrum/radiative_transfer.py:202):
            if model.chem_model is not None:
                vmr_k = model._eval_vmr_pure(vmr_pars, temp)
            else:
                vmr_k = base_vmr
            dens = hydro.ideal_gas_density(vmr_k, press_j, temp)
            mm = hydro.mean_weight(vmr_k, mol_mass_j)
            radius = model.eval_radius(temp, mm)
            ec, ec_cloud, deck_surface = model.extinction(
                temp, radius, dens, pars_list,
            )
            result = model._run_emission(
                ec, ec_cloud, deck_surface, temp, radius, 0, fpatchy,
            )
            return result['flux_up'], result['flux_down']

        step_jit = jax.jit(_step)
        model._radeq_step_cache = step_jit

    def step(temp):
        return step_jit(
            temp, jnp.asarray(press), jnp.asarray(vmr),
            jnp.asarray(mol_mass), model.model_pars(), model.vmr_pars,
            model.fpatchy,
        )

    dpress = np.ediff1d(np.log(press), to_begin=1.0)
    dpress[0] = dpress[1]

    if use_scan is None:
        use_scan = (not convection) and nlayers > 8
    if use_scan and convection:
        raise ValueError(
            'use_scan=True does not support convection (the '
            'convective-flux redo is data-dependent control flow)'
        )
    if use_scan and nlayers <= 8:
        raise ValueError(
            'use_scan=True requires more than 8 layers (the gaussian '
            'smoothing support); use use_scan=False'
        )

    if use_scan:
        # Sign-history buffer: most recent 4 flux-difference signs.
        # The reference recreates df_sign as zeros on every call, so a
        # warm restart begins with up to 4 VALID zero rows (which count
        # as wobble against any nonzero sign) -- reproduced here:
        n_valid0 = min(n_prev - 1, 4)
        valid0 = jnp.arange(4) >= (4 - n_valid0)
        buf0 = jnp.zeros((4, nlayers))
        # One compiled program serves any nsamples: scan in fixed-size
        # chunks (the scan length is baked into the XLA program; the
        # sign history threads through the carry across chunks):
        chunk = min(nsamples, 25)

        run_scan = _radeq_scan_runner(model)
        consts = (
            jnp.asarray(press), jnp.asarray(wn), jnp.asarray(dpress),
            jnp.asarray(vmr), jnp.asarray(mol_mass),
            model.model_pars(), model.vmr_pars,
            jnp.asarray(float(tmin)), jnp.asarray(float(tmax)),
            model.fpatchy,
        )
        carry = (
            jnp.asarray(temps[n_prev - 1]), jnp.asarray(dt_scale),
            buf0, valid0,
        )
        chunks = []
        done = 0
        while done < nsamples:
            length = min(chunk, nsamples - done)
            carry, ts = run_scan(carry, consts, length)
            chunks.append(ts)
            done += length
        temps[n_prev:] = np.concatenate(
            [np.asarray(c) for c in chunks], axis=0,
        )
        model.radeq_temps = temps
        model._dt_scale = np.asarray(carry[1])
        return temps

    df_sign = np.zeros((n_prev + nsamples, nlayers))

    def _update(k, diff_flux, scale):
        """Wobble-damped adaptive temperature update (in place)."""
        df_sign[k] = np.sign(diff_flux)
        lo = max(k - 4, 0)
        wobble = np.any(df_sign[lo:k] - df_sign[k], axis=0)
        scale = np.copy(scale)
        scale[wobble] *= 0.5
        scale[~wobble] *= 1.15
        scale = gaussian_filter1d(np.clip(scale, 1.0, _MAXF), 1.5)
        dt = (
            scale * np.sign(diff_flux) * np.abs(diff_flux)**0.1
            / (pc.sigma_sb * temps[k]**3 * dpress)
        )
        temps[k + 1] = temps[k] + dt
        temps[k + 1, 0] = temps[k + 1, 1]  # isothermal top
        sigma = np.clip(np.mean(np.abs(dt)) / 10.0, 0.75, 2.0)
        temps[k + 1, :-1] = gaussian_filter1d(temps[k + 1], sigma)[:-1]
        temps[k + 1] = np.clip(temps[k + 1], tmin, tmax)
        return scale

    for i in range(nsamples):
        k = n_prev + i - 1
        flux_up, flux_down = step(jnp.asarray(temps[k]))
        q_up = np.trapezoid(np.asarray(flux_up), wn, axis=1)
        q_down = np.trapezoid(np.asarray(flux_down), wn, axis=1)
        q_net = q_up - q_down
        diff_flux = np.ediff1d(q_net, to_begin=0)
        dt_scale_tmp = _update(k, diff_flux, dt_scale)

        if convection:
            temp_new = temps[k + 1]
            # Reference semantics (radiative_transfer.py:240-259): the
            # convective flux is evaluated with the atmospheric state
            # of the step that PRODUCED the fluxes -- densities,
            # radius, and mean weight at temps[k] -- but the updated
            # temperature profile temps[k+1].
            temp_rt = temps[k]
            if model.chem_model is not None and hasattr(
                    model.chem_model, 'heat_capacity'):
                cp_r = np.asarray(
                    model.chem_model.heat_capacity(temp_rt))
                cp = np.sum(cp_r * vmr, axis=1) * pc.k / pc.amu
            else:
                # Diatomic-dominated heat capacity (cp/R = 3.5):
                cp = np.full(nlayers, 3.5) * pc.k / pc.amu
            mm = vmr @ mol_mass
            dens = vmr * (press / temp_rt)[:, None] * pc.bar / pc.k
            rho = np.sum(dens * mol_mass, axis=1) * pc.amu
            radius = np.asarray(model.eval_radius(
                jnp.asarray(temp_rt), jnp.asarray(mm),
            ))
            gravity = pc.G * model.mplanet / radius**2
            conv = np.asarray(convective_flux(
                press * pc.bar, temp_new, cp, gravity, mm, rho,
            ))
            if np.any(conv != 0.0):
                diff_flux = np.ediff1d(q_net + conv, to_begin=0)
                dt_scale = _update(k, diff_flux, dt_scale)
                continue
        dt_scale = dt_scale_tmp

    model.radeq_temps = temps
    model._dt_scale = dt_scale
    return temps
