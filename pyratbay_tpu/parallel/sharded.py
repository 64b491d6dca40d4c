"""Multi-chip SPMD execution of the real forward model.

The scaling model (jax.sharding + GSPMD; the "annotate shardings, let
XLA insert collectives" recipe) over a (chains, wave) device mesh:

* `chains` axis -- data parallel over retrieval chains: the vmapped
  forward is partitioned chain-wise, no communication until the
  sampler's cross-chain moves (an all-gather of the small [nchains,
  npars] state).
* `wave` axis -- sequence-parallel over the wavenumber grid: every
  spectral table of a configured Model (line-sample cross sections,
  CIA tables, Rayleigh/alkali/cloud/H- wavenumber arrays, the
  DirectLBL tile grids, band-integration weights, stellar flux) is
  re-placed on the mesh sharded along its wavenumber dimension.  The
  jitted forward closes over these committed arrays, so GSPMD
  propagates the sharding through extinction -> optical depth ->
  spectrum (all independent per wavelength) and inserts exactly one
  psum where the physics contracts over wavenumber: the band
  integration matvec.  This is the analog of the reference's MPI
  shared-memory opacity window (opacity/line_sampling.py:253-275) --
  except the table is partitioned, not replicated, so memory per chip
  *scales down* with the wave axis.

The line-by-line engine needs no halo exchange in this design: its
wavenumber *tiles* are sharded while the (read-only) line list is
replicated, so each shard gathers the line window it needs -- the
voigt_cutoff-bounded equivalent of the reference's wing spill
(SURVEY.md long-axis notes) resolved at gather time.

`sharded_retrieval_step` runs one DEMC generation of the real
retrieval (the "training step") jitted over the mesh; it is what
`__graft_entry__.dryrun_multichip` compiles and runs, and what
tests/test_parallel.py checks against the single-device forward.
"""
import numpy as np
import jax
import jax.numpy as jnp
from jax import random
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    'make_mesh', 'shard_model_tables', 'sharded_retrieval_step',
    'build_flagship_sharded',
]


def make_mesh(devices=None, chains_axis=None):
    """Build a (chains, wave) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if chains_axis is None:
        # Favor a square-ish split; wave axis gets the larger factor:
        chains_axis = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                chains_axis = f
                break
    wave_axis = n // chains_axis
    mesh_devices = np.asarray(devices).reshape(chains_axis, wave_axis)
    return Mesh(mesh_devices, ('chains', 'wave'))


def _wave_sharding(mesh, ndim):
    """NamedSharding partitioning the trailing axis along 'wave'."""
    return NamedSharding(mesh, P(*([None] * (ndim - 1) + ['wave'])))


def _edge_pad(arr, npad):
    """Repeat the last wave column npad times (physics stays finite on
    padded points; their outputs are never consumed)."""
    pad_widths = [(0, 0)] * (arr.ndim - 1) + [(0, npad)]
    return np.pad(arr, pad_widths, mode='edge')


def _pad_wave_axis(model, obs, npad):
    """Extend the model's wavenumber axis by npad points so it divides
    evenly across the wave shards.

    Physics tables are edge-padded (padded points compute real but
    unused values); the band-integration matrix is zero-padded, so
    band fluxes -- the likelihood inputs -- are exact.  The padded
    region of `spectrum` outputs is garbage by construction; slice
    with model.nwave_unpadded when comparing spectra.
    """
    nwave = model.nwave

    def pad_obj(obj):
        for attr, val in vars(obj).items():
            if isinstance(val, np.ndarray) and val.ndim >= 1 \
                    and val.shape[-1] == nwave \
                    and np.issubdtype(val.dtype, np.floating):
                setattr(obj, attr, _edge_pad(val, npad))

    for mtype, opac_model, _ in model.opacity_models:
        if mtype != 'lbl':
            pad_obj(opac_model)
            if hasattr(opac_model, 'nwave'):
                opac_model.nwave = nwave + npad
    if getattr(model, 'starflux', None) is not None:
        model.starflux = _edge_pad(np.asarray(model.starflux), npad)
    if getattr(model, 'sed_fluxes', None) is not None:
        model.sed_fluxes = _edge_pad(np.asarray(model.sed_fluxes), npad)
    if obs is not None and getattr(obs, '_band_matrix', None) is not None:
        obs._band_matrix = np.pad(
            np.asarray(obs._band_matrix), ((0, 0), (0, npad)),
        )
    model.nwave_unpadded = nwave
    model.wn = _edge_pad(np.asarray(model.wn), npad)
    model.nwave = nwave + npad
    # Direct LBL engines are wn-grid-specific; rebuild against the
    # padded grid (duplicated trailing points compute real, sliced-off
    # values):
    if hasattr(model, '_direct_lbl'):
        model._direct_lbl.clear()


def shard_model_tables(model, obs=None, mesh=None):
    """Re-place every wavenumber-axis spectral table of a configured
    Model (and Observation) onto the mesh, sharded along 'wave'.

    Pads the wave axis to a shard multiple first (band integrals stay
    exact; see _pad_wave_axis).  Mutates the model's opacity objects in
    place (their extinction methods pass the arrays through
    jnp.asarray, which preserves committed shardings); call
    build_forward / build_log_posterior *after* this so the traced
    closures capture the sharded arrays.
    """
    nshards = mesh.shape['wave']
    npad = (-model.nwave) % nshards
    if npad:
        _pad_wave_axis(model, obs, npad)
    nwave = model.nwave

    def shard_obj(obj):
        for attr, val in vars(obj).items():
            if isinstance(val, np.ndarray) and val.ndim >= 1 \
                    and val.shape[-1] == nwave \
                    and np.issubdtype(val.dtype, np.floating):
                setattr(obj, attr, jax.device_put(
                    val, _wave_sharding(mesh, val.ndim),
                ))

    for mtype, opac_model, _ in model.opacity_models:
        if mtype == 'lbl':
            # The parity engine stays host-side (numpy); the jit path
            # goes through DirectLBL, whose tile grids shard instead:
            _shard_direct_lbl(
                model.direct_lbl(opac_model), mesh, nshards,
            )
        else:
            shard_obj(opac_model)

    if getattr(model, 'starflux', None) is not None:
        model.starflux = jax.device_put(
            np.asarray(model.starflux), _wave_sharding(mesh, 1),
        )
    if getattr(model, 'sed_fluxes', None) is not None:
        model.sed_fluxes = jax.device_put(
            np.asarray(model.sed_fluxes), _wave_sharding(mesh, 2),
        )
    if obs is not None and getattr(obs, '_band_matrix', None) is not None:
        obs._band_matrix = jax.device_put(
            np.asarray(obs._band_matrix), _wave_sharding(mesh, 2),
        )
    return model, obs


def _shard_direct_lbl(engine, mesh, nshards):
    """Shard a DirectLBL engine's tile grids along 'wave'; the
    (read-only) line list replicates, so every shard can gather its
    cutoff-bounded line window locally -- no halo exchange.

    Tile rows are duplicated up to a shard multiple; the engine's
    flatten-and-slice ([:, :nwave]) discards the extra outputs.
    """
    pad_wing = (-engine.ntiles) % nshards
    pad_core = (-engine.ntiles_core) % nshards
    sharded = {}
    for key, val in engine._tables.items():
        if key.startswith(('w_', 'wn_tiles_')):
            npad = pad_wing
        elif key.startswith(('c_', 'wn_core_')):
            npad = pad_core
        else:
            sharded[key] = jax.device_put(
                val, NamedSharding(mesh, P()),
            )
            continue
        if npad:
            reps = [val[-1:]] * npad
            val = np.concatenate([val] + reps, axis=0)
        sharded[key] = jax.device_put(
            val, NamedSharding(mesh, P('wave', None)),
        )
    engine._device_tables = sharded


def sharded_retrieval_step(log_post, ret, mesh, nchains=None, seed=0):
    """One jitted DEMC generation of the real retrieval over the mesh.

    Parameters
    ----------
    log_post: pure params -> scalar log-posterior (built against
        wave-sharded tables via shard_model_tables + build_log_posterior).
    ret: RetrievalParams -- initial values / steps / bounds.
    mesh: (chains, wave) device mesh.
    nchains: ensemble size (default 4x the chain-shard count, >= 16).

    Returns (step_fn, chains0, logp0) with
    step_fn(chains, logp, key) -> (chains, logp); chains stay sharded
    P('chains', None) across steps.
    """
    from ..retrieval.samplers import _propose_de, _propose_snooker

    chain_shards = mesh.shape['chains']
    if nchains is None:
        nchains = max(16, 4 * chain_shards)
    nchains -= nchains % chain_shards

    params0 = np.asarray(ret.params, float)
    pstep = np.asarray(ret.pstep, float)
    free_mask = (pstep > 0).astype(float)
    d_free = max(free_mask.sum(), 1.0)
    gamma0 = 2.38 / np.sqrt(2.0 * d_free)
    eps_scale = 1e-4 * np.where(pstep > 0, pstep, 0.0)

    rng = np.random.default_rng(seed)
    chains0 = params0 + np.where(pstep > 0, pstep, 0.0) \
        * rng.standard_normal((nchains, len(params0)))
    chains0 = np.clip(chains0, np.asarray(ret.pmin), np.asarray(ret.pmax))

    chain_sharding = NamedSharding(mesh, P('chains', None))
    scalar_sharding = NamedSharding(mesh, P('chains'))
    vmapped = jax.vmap(log_post)

    def step(chains, logp, key):
        k_choice, k_de, k_snook, k_accept = random.split(key, 4)
        prop_de, mh_de = _propose_de(
            k_de, chains, gamma0, jnp.asarray(eps_scale),
            jnp.asarray(free_mask),
        )
        prop_sn, mh_sn = _propose_snooker(
            k_snook, chains, jnp.asarray(free_mask),
        )
        use_snooker = (
            random.uniform(k_choice, (chains.shape[0], 1)) < 0.1
        )
        prop = jnp.where(use_snooker, prop_sn, prop_de)
        log_mh = jnp.where(use_snooker[:, 0], mh_sn, mh_de)
        logp_prop = vmapped(prop)
        accept = (
            jnp.log(random.uniform(k_accept, (chains.shape[0],)))
            < logp_prop - logp + log_mh
        )
        new_chains = jnp.where(accept[:, None], prop, chains)
        new_logp = jnp.where(accept, logp_prop, logp)
        return new_chains, new_logp

    jitted = jax.jit(
        step,
        out_shardings=(chain_sharding, scalar_sharding),
    )

    chains_dev = jax.device_put(
        np.asarray(chains0, np.float32), chain_sharding,
    )
    return jitted, chains_dev, scalar_sharding


def build_flagship_sharded(mesh, workdir=None, **flagship_kw):
    """Flagship retrieval (benchmark.make_flagship) with wave-sharded
    tables: returns (model, obs, ret, log_post, step_fn, chains0).
    """
    from ..benchmark import make_flagship
    from ..retrieval.forward import build_log_posterior

    model, obs, ret, forward, p0 = make_flagship(workdir, **flagship_kw)
    if obs.data is None:
        # Synthesize observations from the model itself so the
        # likelihood is well-posed:
        bandflux = np.asarray(jax.jit(forward)(p0)['bandflux'])
        obs.data = bandflux
        obs.uncert = np.maximum(0.03 * bandflux, 1e-12)
    shard_model_tables(model, obs, mesh)
    log_post = build_log_posterior(model, obs, ret)
    step_fn, chains0, logp_sharding = sharded_retrieval_step(
        log_post, ret, mesh,
    )
    return model, obs, ret, log_post, step_fn, chains0, logp_sharding
