"""Top-level driver: dispatch a configuration to its run mode.

Reference behavior: pyratbay/driver.py (runmode in {tli, atmosphere,
opacity, spectrum, radeq, retrieval}).
"""
import numpy as np

from . import constants as pc
from .config import parser as cfg_parser
from .io import io as pio
from .model import Model

__all__ = ['run']


def run(cfile, root=None, with_log=True):
    """Execute a run mode from a configuration file.

    Returns the Model (spectrum/opacity/retrieval/radeq modes), the
    TLI summary list (tli mode), or the atmosphere tuple (atmosphere
    mode).  with_log=False suppresses the log file (screen only).
    """
    cfg = cfg_parser.parse(cfile, root=root)
    runmode = cfg.runmode

    # Multi-host bootstrap (no-op unless dist_* keys / PBT_* env are
    # set; parallel/distributed.py):
    from .parallel.distributed import initialize_distributed
    initialize_distributed(cfg)

    # Run log: screen + file tee, rank-0 only (logger.Log):
    from .logger import Log
    from .version import __version__
    logname = cfg.logfile if with_log else None
    try:
        log = Log(
            logname=logname,
            verb=cfg.verb if cfg.verb is not None else 2,
            append=bool(cfg.resume),
        )
    except OSError:
        log = Log(verb=cfg.verb if cfg.verb is not None else 2)
        log.warning(f'Could not open log file {logname!r}')
    log.head(
        f"{log.sep}\n  pyratbay_tpu v{__version__}: radiative transfer "
        f"in a Bayesian framework\n"
        f"  Run mode: {runmode}\n  Config: {cfile}\n{log.sep}"
    )
    return _dispatch(cfg, runmode, root, log)


def _dispatch(cfg, runmode, root, log):

    if runmode == 'tli':
        from .opacity.tli import make_tli
        tlifile = cfg.tlifile[0] if cfg.tlifile else None
        if tlifile is None and cfg.logfile is not None:
            import os
            tlifile = os.path.splitext(cfg.logfile)[0] + '.tli'
        wl_units = cfg.wlunits or 'um'
        return make_tli(
            cfg.dblist, cfg.pflist, cfg.dbtype, tlifile,
            cfg.wl_low / pc.u(wl_units), cfg.wl_high / pc.u(wl_units),
            wl_units,
        )

    if runmode == 'atmosphere':
        model = Model(cfg, root=root, log=log)
        temp = np.asarray(model.eval_temp())
        vmr = model.base_vmr
        radius = None
        if model.rmodelname is not None and vmr is not None:
            from .atmosphere import hydro
            mm = hydro.mean_weight(vmr, model.mol_mass)
            radius = np.asarray(model.eval_radius(temp, mm))
        if cfg.output_atmfile is not None:
            pio.write_atm(
                cfg.output_atmfile, model.press, temp, model.species,
                vmr, radius, punits='bar',
            )
        return model

    model = Model(cfg, root=root, log=log)

    if runmode == 'opacity':
        model.compute_opacity()
        log.summary(model.timestamps)
        return model

    if runmode == 'spectrum':
        model.run()
        if cfg.specfile is not None:
            wl = 1.0 / (model.wn * pc.um)
            if model.rt_path in pc.TRANSMISSION_RT:
                spec_type = 'transit'
            elif model.rt_path in pc.EMISSION_RT:
                spec_type = 'emission'
            else:
                spec_type = 'eclipse'
            pio.write_spectrum(wl, model.spectrum, cfg.specfile, spec_type)
        log.summary(model.timestamps)
        return model

    if runmode == 'radeq':
        from .spectrum.radeq import radiative_equilibrium
        # Reference semantics (pyrat_obj.py:588-611): iteration count
        # from the config, temperature clips from the opacity models'
        # common validity range, warm restart via resume:
        nsamples = cfg.nsamples or 100
        tmin = max(model.tmin.values(), default=0.0)
        tmax = min(model.tmax.values(), default=6000.0)
        warm = {}
        if cfg.resume and getattr(model, 'radeq_temps', None) is not None:
            warm = dict(
                radeq_temps=model.radeq_temps,
                dt_scale=model._dt_scale,
            )
        temps = radiative_equilibrium(
            model, nsamples=int(nsamples), tmin=tmin, tmax=tmax, **warm,
        )
        if cfg.logfile is not None:
            import os
            base = os.path.splitext(cfg.logfile)[0]
            np.savez(
                base + '.npz', pressure=model.press, temps=temps,
            )
            pio.write_atm(
                base + '.atm', model.press, temps[-1], model.species,
                model.base_vmr, punits='bar',
            )
        log.summary(getattr(model, 'timestamps', None))
        return model

    if runmode == 'retrieval':
        from .retrieval.driver import run_retrieval
        run_retrieval(model)
        log.summary(model.timestamps)
        return model

    raise ValueError(f"Invalid runmode '{runmode}'")
