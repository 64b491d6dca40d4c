"""Device-resident MCMC: differential-evolution (DEMC) with snooker
updates, running the whole ensemble as one vmapped computation.

The reference runs nchains worker processes each calling the forward
model once per step (mc3 snooker DEMC).  Here every generation
evaluates all chains in a single vmapped forward pass -- thousands of
chains per device -- and the generation loop is a lax.scan, so the
entire sampler compiles to one XLA program.

Moves (ter Braak 2006; ter Braak & Vrugt 2008):
  * DE move: x' = x + gamma (x_r1 - x_r2) + e,  gamma = 2.38/sqrt(2 d)
    (gamma = 1 every 10th generation for mode jumps);
  * snooker move (10% of proposals): stretch along (x - z) with the
    difference of two other chains projected onto that line.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, random

__all__ = ['sample_demc', 'gelman_rubin']


def _propose_de(key, chains, gamma, eps_scale, free_mask):
    """Differential-evolution proposals for all chains at once."""
    nchains, npars = chains.shape
    key_r1, key_r2, key_e = random.split(key, 3)
    # Random distinct partners (distinct from self with high prob. for
    # large ensembles; collisions only waste a proposal):
    r1 = random.randint(key_r1, (nchains,), 0, nchains - 1)
    r1 = jnp.where(r1 >= jnp.arange(nchains), r1 + 1, r1)
    r2 = random.randint(key_r2, (nchains,), 0, nchains - 1)
    r2 = jnp.where(r2 >= jnp.arange(nchains), r2 + 1, r2)
    diff = chains[r1] - chains[r2]
    noise = eps_scale * random.normal(key_e, chains.shape)
    prop = chains + (gamma * diff + noise) * free_mask
    return prop, jnp.zeros(chains.shape[0])  # symmetric: no MH factor


def _propose_snooker(key, chains, free_mask):
    """Snooker proposals: stretch along the line to a random chain."""
    nchains, npars = chains.shape
    kz, kr1, kr2, kg = random.split(key, 4)
    z_idx = random.randint(kz, (nchains,), 0, nchains - 1)
    z_idx = jnp.where(z_idx >= jnp.arange(nchains), z_idx + 1, z_idx)
    z = chains[z_idx]
    r1 = random.randint(kr1, (nchains,), 0, nchains)
    r2 = random.randint(kr2, (nchains,), 0, nchains)
    gamma_s = random.uniform(kg, (nchains, 1), minval=1.2, maxval=2.2)

    dz = chains - z
    norm2 = jnp.sum(dz * dz, axis=1, keepdims=True)
    safe = jnp.where(norm2 > 0, norm2, 1.0)
    # Project (x_r1 - x_r2) onto the x-z line:
    proj = jnp.sum((chains[r1] - chains[r2]) * dz, axis=1, keepdims=True)
    prop = chains + gamma_s * proj * dz / safe * free_mask
    # Metropolis-Hastings factor |x'-z|^(d-1)/|x-z|^(d-1):
    d_free = jnp.sum(free_mask)
    new_norm2 = jnp.sum((prop - z)**2, axis=1)
    log_mh = 0.5 * (d_free - 1.0) * (
        jnp.log(jnp.where(new_norm2 > 0, new_norm2, 1.0))
        - jnp.log(jnp.where(norm2[:, 0] > 0, norm2[:, 0], 1.0))
    )
    return prop, log_mh


def sample_demc(
        log_post, init_params, nsamples, key=None, nchains=None,
        pstep=None, pmin=None, pmax=None,
        snooker_fraction=0.1, thin=1, burnin=0,
        checkpoint_file=None, checkpoint_dt=None, resume=False,
        chunk_gens=None, log=None, log_post_batched=None,
        adapt_gamma=False, target_acceptance=0.234, gamma_init=None,
        history_thin=1,
    ):
    """Run snooker-DEMC over a vmapped ensemble.

    Parameters
    ----------
    log_post: params [npars] -> scalar log-posterior (pure function).
    log_post_batched: optional params [B, npars] -> [B] ensemble
        evaluator (retrieval/batched.py) used instead of
        vmap(log_post) -- the layout-copy-free hot path.
    adapt_gamma: scale the DE step size between scan chunks toward
        `target_acceptance` (Robbins-Monro on the host; OFF by
        default -- the reference's snooker DEMC uses the fixed
        2.38/sqrt(2d) factor).  Adaptation changes only the proposal
        scale, not detailed balance within a chunk.
    gamma_init: starting DE scale (default 2.38/sqrt(2 d_free));
        results['gamma_final'] returns the adapted value so repeat
        calls can continue adaptation.
    history_thin: record every n-th generation in the returned
        chain_history/posterior (the inner generations run device-side
        with no per-step outputs).  Cuts the device-to-host history
        volume by n -- long ensemble runs are otherwise
        fetch-bound.  burnin/thin then count in RECORDED
        samples.
    init_params: [npars] center for initialization, or [nchains, npars]
        explicit initial ensemble.
    nsamples: total number of posterior draws (nchains * ngen).
    pstep: per-parameter scale (0 = fixed); used for initialization
        jitter and proposal noise.
    checkpoint_file: npz path for periodic chain-state checkpoints
        (written every checkpoint_dt seconds, default 600; the analog
        of the reference's dt_retrieval_snapshot,
        tools/retrieval_tools.py:81-170).
    resume: continue from checkpoint_file if it exists.
    chunk_gens: generations per jitted scan chunk (default: sized so
        checkpoints are possible; one chunk when no checkpointing).

    Returns dict with 'posterior' [nkept, npars], 'log_post' [nkept],
    'chains' (final state), 'acceptance_rate', 'bestp', 'best_log_post'.
    """
    import os
    import time
    if key is None:
        key = random.PRNGKey(0)
    init_params = jnp.atleast_2d(jnp.asarray(init_params, jnp.float64))
    if init_params.shape[0] == 1:
        if nchains is None:
            raise ValueError('nchains needed with a single init vector')
        npars = init_params.shape[1]
        step = (
            jnp.where(jnp.asarray(pstep) > 0, jnp.asarray(pstep), 0.0)
            if pstep is not None else 0.01 * jnp.abs(init_params[0]) + 1e-4
        )
        key, kinit = random.split(key)
        chains = init_params + step * random.normal(
            kinit, (nchains, npars),
        )
    else:
        chains = init_params
        nchains, npars = chains.shape
    if pmin is not None:
        chains = jnp.clip(
            chains, jnp.asarray(pmin), jnp.asarray(pmax),
        )

    free_mask = (
        (jnp.asarray(pstep) > 0).astype(chains.dtype)
        if pstep is not None else jnp.ones(npars, chains.dtype)
    )
    d_free = float(np.sum(np.asarray(free_mask)))
    gamma0 = (
        float(gamma_init) if gamma_init is not None
        else 2.38 / np.sqrt(2.0 * max(d_free, 1.0))
    )
    eps_scale = 1e-4 * jnp.where(
        jnp.asarray(pstep) > 0, jnp.asarray(pstep), 0.0,
    ) if pstep is not None else 1e-6

    vmapped_logpost = (
        log_post_batched if log_post_batched is not None
        else jax.vmap(log_post)
    )

    ngen = int(np.ceil(nsamples / nchains))
    igen0 = 0
    hist0 = []
    gamma_resume = eps_resume = None
    if resume and checkpoint_file is not None \
            and os.path.isfile(checkpoint_file):
        ckpt = np.load(checkpoint_file)
        chains = jnp.asarray(ckpt['chains'])
        igen0 = int(ckpt['igen'])
        hist0 = [(
            ckpt['hist_chains'], ckpt['hist_logp'], ckpt['hist_accept'],
        )]
        # Adapted proposal state (written by newer checkpoints): a
        # resumed adapt_gamma run continues from the adapted scale
        # instead of snapping back to gamma0:
        if 'gamma' in ckpt.files:
            gamma_resume = float(ckpt['gamma'])
        if 'eps_scale' in ckpt.files:
            eps_resume = np.asarray(ckpt['eps_scale'])
        if log is not None:
            log.msg(
                f'Resuming retrieval from {checkpoint_file} at '
                f'generation {igen0}/{ngen}'
            )
    logp = vmapped_logpost(chains)

    # The jitted generation scan is compiled once per evaluator and
    # cached on the evaluator function object: repeat sample_demc
    # calls (convergence-checked chunks, warm restarts) must not
    # re-trace the full forward model (the round-3 radeq lesson).
    # Everything that can change between calls (gamma0, eps_scale,
    # free_mask, the chain state) threads through the scan carry:
    cache_host = (
        log_post_batched if log_post_batched is not None else log_post
    )
    scan_chunk = getattr(cache_host, '_demc_scan', None)
    if scan_chunk is None or getattr(
            cache_host, '_demc_scan_meta', None) != (
                snooker_fraction, history_thin):

        def generation(state, inputs):
            chains, logp, gamma0_c, eps_scale_c, free_mask_c = state
            key, gen_idx = inputs
            k_choice, k_de, k_snook, k_accept = random.split(key, 4)

            gamma = jnp.where(gen_idx % 10 == 9, 1.0, gamma0_c)
            prop_de, mh_de = _propose_de(
                k_de, chains, gamma, eps_scale_c, free_mask_c,
            )
            prop_sn, mh_sn = _propose_snooker(
                k_snook, chains, free_mask_c,
            )
            use_snooker = (
                random.uniform(k_choice, (chains.shape[0], 1))
                < snooker_fraction
            )
            prop = jnp.where(use_snooker, prop_sn, prop_de)
            log_mh = jnp.where(use_snooker[:, 0], mh_sn, mh_de)

            logp_prop = vmapped_logpost(prop)
            log_alpha = logp_prop - logp + log_mh
            accept = (
                jnp.log(random.uniform(k_accept, (chains.shape[0],)))
                < log_alpha
            )
            new_chains = jnp.where(accept[:, None], prop, chains)
            new_logp = jnp.where(accept, logp_prop, logp)
            return (
                (new_chains, new_logp, gamma0_c, eps_scale_c,
                 free_mask_c),
                (new_chains, new_logp, accept),
            )

        scan_plain = jax.jit(lambda carry, xs: lax.scan(
            generation, carry, xs,
        ))
        if history_thin > 1:
            def gen_inner(carry, inputs):
                new_carry, (_c, _l, accept) = generation(carry, inputs)
                return new_carry, accept

            def gen_outer(carry, inputs):
                carry, accepts = lax.scan(gen_inner, carry, inputs)
                return carry, (carry[0], carry[1], accepts[-1])

            def scan_fn(carry, xs):
                # Callers hand this whole-stride chunks only (the
                # chunk loop routes any % history_thin remainder
                # through scan_plain so every requested generation
                # actually runs):
                keys_x, ids_x = xs
                nrec = keys_x.shape[0] // history_thin
                keys_b = keys_x[:nrec * history_thin].reshape(
                    nrec, history_thin, *keys_x.shape[1:])
                ids_b = ids_x[:nrec * history_thin].reshape(
                    nrec, history_thin)
                return lax.scan(gen_outer, carry, (keys_b, ids_b))

            scan_chunk = jax.jit(scan_fn)
        else:
            scan_chunk = scan_plain
        cache_host._demc_scan = (scan_chunk, scan_plain)
        cache_host._demc_scan_meta = (snooker_fraction, history_thin)
    else:
        scan_chunk, scan_plain = scan_chunk

    # Chunked scanning: each chunk is one jitted lax.scan; between
    # chunks the host can checkpoint the chain state (resume support):
    if chunk_gens is None:
        chunk_gens = ngen if checkpoint_file is None \
            else max(1, min(200, ngen))
    keys = random.split(key, ngen)
    gen_ids = jnp.arange(ngen)
    hist_parts = list(hist0)
    carry = (
        chains, logp,
        jnp.asarray(gamma0 if gamma_resume is None else gamma_resume),
        (jnp.asarray(eps_scale) * jnp.ones(npars)
         if eps_resume is None else jnp.asarray(eps_resume)),
        jnp.asarray(free_mask),
    )
    t_last = time.time()
    dt_ckpt = checkpoint_dt if checkpoint_dt is not None else 600.0
    igen = igen0
    while igen < ngen:
        hi = min(igen + chunk_gens, ngen)
        # The thinned scan only executes whole history_thin strides;
        # route any remainder (chunk_gens not a multiple, or the final
        # partial chunk) through the plain scan so every generation up
        # to `hi` actually runs and igen never overstates the chain's
        # evolution:
        n_gens = hi - igen
        rem = n_gens % history_thin if history_thin > 1 else 0
        mid = hi - rem
        if mid > igen:
            carry, (h_c, h_l, h_a) = scan_chunk(
                carry, (keys[igen:mid], gen_ids[igen:mid]),
            )
            hist_parts.append((
                np.asarray(h_c), np.asarray(h_l), np.asarray(h_a),
            ))
        if rem:
            carry, (r_c, r_l, r_a) = scan_plain(
                carry, (keys[mid:hi], gen_ids[mid:hi]),
            )
            # One record for the partial stride (its final state):
            hist_parts.append((
                np.asarray(r_c[-1:]), np.asarray(r_l[-1:]),
                np.asarray(r_a[-1:]),
            ))
        igen = hi
        if adapt_gamma:
            acc = float(hist_parts[-1][2].mean())
            factor = float(np.exp(
                np.clip(acc - target_acceptance, -0.25, 0.25),
            ))
            carry = (
                carry[0], carry[1], carry[2] * factor, carry[3],
                carry[4],
            )
        if checkpoint_file is not None and (
                time.time() - t_last > dt_ckpt or igen == ngen):
            np.savez(
                checkpoint_file,
                chains=np.asarray(carry[0]),
                igen=igen,
                gamma=np.asarray(carry[2]),
                eps_scale=np.asarray(carry[3]),
                hist_chains=np.concatenate(
                    [h[0] for h in hist_parts]),
                hist_logp=np.concatenate([h[1] for h in hist_parts]),
                hist_accept=np.concatenate(
                    [h[2] for h in hist_parts]),
            )
            t_last = time.time()
            if log is not None:
                log.msg(
                    f'Checkpoint at generation {igen}/{ngen} '
                    f'-> {checkpoint_file}'
                )
    chains, logp = carry[0], carry[1]
    hist_chains = np.concatenate([h[0] for h in hist_parts])
    hist_logp = np.concatenate([h[1] for h in hist_parts])
    hist_accept = np.concatenate([h[2] for h in hist_parts])

    kept = hist_chains[burnin::thin]
    kept_logp = hist_logp[burnin::thin]
    posterior = kept.reshape(-1, npars)
    flat_logp = kept_logp.reshape(-1)
    ibest = jnp.argmax(flat_logp)
    return {
        'gamma_final': float(np.asarray(carry[2])),
        'posterior': posterior,
        'log_post': flat_logp,
        'chains': chains,
        'chain_history': hist_chains,
        'acceptance_rate': jnp.mean(hist_accept),
        'bestp': posterior[ibest],
        'best_log_post': flat_logp[ibest],
    }


def gelman_rubin(chain_history):
    """Gelman-Rubin potential scale reduction factor per parameter.

    chain_history: [ngen, nchains, npars] post-burn-in samples.
    """
    chain_history = jnp.asarray(chain_history)
    ngen, nchains, npars = chain_history.shape
    chain_means = jnp.mean(chain_history, axis=0)       # [nchains, npars]
    grand_mean = jnp.mean(chain_means, axis=0)
    between = ngen / (nchains - 1) * jnp.sum(
        (chain_means - grand_mean)**2, axis=0,
    )
    within = jnp.mean(jnp.var(chain_history, axis=0, ddof=1), axis=0)
    var_est = (ngen - 1) / ngen * within + between / ngen
    return jnp.sqrt(var_est / jnp.where(within > 0, within, 1.0))
