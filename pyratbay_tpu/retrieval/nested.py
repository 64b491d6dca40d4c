"""Device-resident nested sampling (MultiNest-capability interface).

Skilling nested sampling with batched MCMC replacement, designed for
an accelerator's batch appetite instead of MultiNest's MPI likelihood farm
(reference pyratbay/tools/retrieval_tools.py:233-383):

* nlive live points evolve on device; every scan step removes the
  `batch` worst points at once and replaces them with vmapped MCMC
  walks (the whole proposal population evaluates as one batched
  forward pass).
* Proposals use the live set's full covariance Cholesky factor, so
  correlated posteriors mix well; walks start from random survivors,
  which also seeds replacements across separated modes.
* The evidence accumulation uses the exact order statistics of
  without-replacement batch removal: the k-th point removed from a
  set of (nlive - k) carries a log-volume shrink of 1/(nlive - k).

Outputs match the MultiNest post-processing contract: weighted samples
(with log-weights), logZ (+ information-based uncertainty), and an
equally-weighted posterior via posterior.weighted_to_equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, random

__all__ = ['sample_nested', 'identify_modes']


def _bootstrap_logz_err(dead_logl, live_logl, nlive, batch, n_use,
                        n_boot=200, seed=0):
    """Monte-Carlo logZ uncertainty from the stochastic prior-volume
    shrinkage (the resampling estimate MultiNest-style post-processing
    relies on, instead of the information heuristic): each removal of
    the k-th point of a batch compresses the volume by t ~ Beta(m, 1)
    with m = nlive - k active points, so -ln t ~ Exp(m).  Redrawing
    every compression factor and re-accumulating Z samples the full
    logZ distribution of the run."""
    rng = np.random.default_rng(seed)
    niter = n_use
    m = np.tile(
        [nlive - k for k in range(batch)], -(-niter // batch),
    )[:niter].astype(float)
    logz_samples = np.empty(n_boot)
    for b in range(n_boot):
        dlog_x = rng.exponential(1.0 / m)
        log_x = -np.cumsum(dlog_x)
        log_w = np.log(-np.diff(
            np.exp(np.concatenate([[0.0], log_x])),
        ))
        x_rem = np.exp(log_x[-1]) if niter else 1.0
        live_logw = np.full(len(live_logl), np.log(x_rem / len(live_logl)))
        log_zw = np.concatenate([
            log_w + dead_logl[:niter], live_logw + live_logl,
        ])
        logz_samples[b] = np.logaddexp.reduce(log_zw)
    return float(np.std(logz_samples))


def identify_modes(samples, weights, link_scale=0.3):
    """Friends-of-friends mode separation of a weighted posterior
    (the capability of MultiNest's live mode clustering,
    reference tools/retrieval_tools.py:233-383, applied to the
    finished run): points within `link_scale` weighted-std units of
    each other join the same mode.

    Returns
    -------
    labels [n] int -- mode index per sample (weight-ordered: mode 0
        carries the most posterior mass).
    """
    samples = np.asarray(samples, float)
    weights = np.asarray(weights, float)
    n, ndim = samples.shape
    wsum = weights.sum()
    mean = (weights[:, None] * samples).sum(0) / wsum
    std = np.sqrt(
        (weights[:, None] * (samples - mean)**2).sum(0) / wsum,
    )
    std = np.where(std > 0, std, 1.0)
    x = samples / std
    eps2 = (link_scale * ndim**0.5)**2

    # Cluster only the points carrying the posterior mass (99.9%):
    # early (prior-volume) dead points otherwise bridge separated
    # modes into one percolating FoF group.  The negligible-weight
    # remainder joins its nearest cluster afterwards.
    order_w = np.argsort(-weights)
    cum = np.cumsum(weights[order_w]) / wsum
    n_core = int(np.searchsorted(cum, 0.999)) + 1
    core = order_w[:n_core]
    in_core = np.zeros(n, bool)
    in_core[core] = True

    labels = np.full(n, -1, int)
    mode = 0
    for seed_i in core:
        if labels[seed_i] >= 0:
            continue
        stack = [seed_i]
        labels[seed_i] = mode
        while stack:
            i = stack.pop()
            d2 = np.sum((x - x[i])**2, axis=1)
            hit = np.where((d2 < eps2) & (labels < 0) & in_core)[0]
            labels[hit] = mode
            stack.extend(hit.tolist())
        mode += 1
    # Attach the mass-less tail to the nearest core point's mode:
    tail = np.where(~in_core)[0]
    if len(tail) and len(core):
        for i in tail:
            d2 = np.sum((x[core] - x[i])**2, axis=1)
            labels[i] = labels[core[np.argmin(d2)]]
    # Order modes by posterior mass:
    masses = np.array([
        weights[labels == k].sum() for k in range(mode)
    ])
    order = np.argsort(-masses)
    remap = np.empty(mode, int)
    remap[order] = np.arange(mode)
    return remap[labels]


def sample_nested(
        log_like, prior_transform, ndim, nlive=400, key=None,
        max_iter=None, stop_dlogz=0.1, nsteps_walk=25, batch=None,
        mesh=None,
    ):
    """Nested sampling with batched MCMC replacement.

    Parameters
    ----------
    log_like: pure function theta [ndim] -> scalar log-likelihood.
    prior_transform: pure function u [ndim] in (0,1) -> theta (the
        MultiNest-style unit-cube mapping).
    ndim: number of parameters.
    nlive: number of live points.
    max_iter: dead-point cap (default 50 * nlive).
    stop_dlogz: terminate when the live-set evidence contribution
        drops below this fraction of the accumulated evidence.
    nsteps_walk: MCMC steps per replacement walk.
    batch: points removed/replaced per scan step (default nlive//16;
        larger batches keep the device busier per compile step).
    mesh: optional jax.sharding.Mesh with a 'chains' axis: the batched
        likelihood evaluations (the walk proposals and the live-set
        init) are sharded across it, the device analog of MultiNest's
        MPI likelihood farm (reference
        tools/retrieval_tools.py:233-307).  Results are identical to
        the single-device run (the algorithm's randomness is
        device-count independent); `batch` is adjusted to a multiple
        of the chain-shard count.

    Returns
    -------
    dict with 'samples' [n, ndim] (physical), 'log_weights',
    'log_like', 'weights', 'logz', 'logz_err', 'posterior'
    (equal-weighted), 'n_iter', 'efficiency'.
    """
    if key is None:
        key = random.PRNGKey(0)
    if max_iter is None:
        max_iter = 50 * nlive
    if batch is None:
        batch = max(1, nlive // 16)
    batch = int(min(batch, nlive // 2))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        nsh = mesh.shape['chains']
        batch = max(batch, nsh) - (max(batch, nsh) % nsh)
        pt_sharding = NamedSharding(mesh, P('chains', None))

        def shard_pts(x):
            return jax.lax.with_sharding_constraint(x, pt_sharding)
    else:
        def shard_pts(x):
            return x
    n_scan = max(1, -(-max_iter // batch))

    v_loglike = jax.vmap(lambda u: log_like(prior_transform(u)))

    key, k_init = random.split(key)
    live_u = random.uniform(k_init, (nlive, ndim))
    live_logl = jax.jit(
        lambda u: v_loglike(shard_pts(u))
    )(live_u)
    gamma = 2.38 / np.sqrt(ndim)

    def ns_step(state, key):
        """Remove the `batch` worst points; walk clones above L_star."""
        live_u, live_logl = state
        order = jnp.argsort(live_logl)
        idead = order[:batch]                 # worst -> best of batch
        dead_u = live_u[idead]
        dead_logl = live_logl[idead]
        logl_star = dead_logl[-1]             # hardest constraint

        k_pick, k_walk = random.split(key)
        # Clone random SURVIVORS (ranks >= batch):
        src = order[batch + random.randint(
            k_pick, (batch,), 0, nlive - batch,
        )]
        u0 = shard_pts(live_u[src])
        logl0 = live_logl[src]

        # Full-covariance proposal scale from the live set:
        cov = jnp.cov(live_u.T) + 1e-10 * jnp.eye(ndim)
        cov = jnp.atleast_2d(cov)
        chol = jnp.linalg.cholesky(cov)

        def walk_step(carry, inputs):
            k, scale = inputs
            u, logl = carry
            k1, k2 = random.split(k)
            step = (
                scale * gamma * random.normal(k1, (batch, ndim))
                @ chol.T
            )
            prop = shard_pts(jnp.clip(u + step, 1e-10, 1.0 - 1e-10))
            logl_prop = v_loglike(prop)
            accept = logl_prop > logl_star
            u = jnp.where(accept[:, None], prop, u)
            logl = jnp.where(accept, logl_prop, logl)
            return (u, logl), jnp.mean(accept)

        # Laddered step scales: full-covariance steps exchange walkers
        # between separated modes, 0.3x/0.1x steps keep acceptance up
        # INSIDE tight modes so narrow peaks hold their live-point
        # share (the failure mode MultiNest's clustering guards
        # against):
        keys = random.split(k_walk, nsteps_walk)
        scales = jnp.asarray(
            np.tile([1.0, 0.3, 0.1], -(-nsteps_walk // 3))[:nsteps_walk]
        )
        (u_new, logl_new), accepts = lax.scan(
            walk_step, (u0, logl0), (keys, scales),
        )

        new_live_u = live_u.at[idead].set(u_new)
        new_live_logl = live_logl.at[idead].set(logl_new)
        return (new_live_u, new_live_logl), (
            dead_u, dead_logl, jnp.mean(accepts),
        )

    keys = random.split(key, n_scan)
    (live_u, live_logl), (dead_u, dead_logl, acc) = lax.scan(
        ns_step, (live_u, live_logl), keys,
    )
    dead_u = np.asarray(dead_u).reshape(-1, ndim)
    dead_logl = np.asarray(dead_logl).reshape(-1)
    live_u_np = np.asarray(live_u)
    live_logl_np = np.asarray(live_logl)

    # Evidence accumulation (host side -- trivial cost).  Within each
    # batch the k-th removed point (k = 0..batch-1) shrinks the prior
    # volume by 1/(nlive - batch + 1 + k)... ordered worst-first, the
    # k-th of the batch is drawn from (nlive - k) active points:
    niter = len(dead_logl)
    dlog_x = np.tile(
        [1.0 / (nlive - k) for k in range(batch)], n_scan,
    )[:niter]
    log_x = -np.cumsum(dlog_x)
    log_w = np.log(-np.diff(np.exp(np.concatenate([[0.0], log_x]))))
    log_zw = log_w + dead_logl

    # Truncate where the remaining live contribution is negligible:
    logz_run = np.logaddexp.accumulate(log_zw)
    n_use = niter
    for i in range(niter):
        rem = np.max(live_logl_np) + log_x[i]
        if rem - logz_run[i] < np.log(stop_dlogz):
            n_use = i + 1
            break

    dead_u = dead_u[:n_use]
    dead_logl = dead_logl[:n_use]
    log_w = log_w[:n_use]

    # Add the remaining live points with equal X weight:
    x_rem = np.exp(log_x[n_use - 1]) if n_use else 1.0
    live_logw = np.full(nlive, np.log(x_rem / nlive))
    all_u = np.vstack([dead_u, live_u_np])
    all_logl = np.concatenate([dead_logl, live_logl_np])
    all_logw = np.concatenate([log_w, live_logw])

    log_zw_all = all_logw + all_logl
    logz = float(np.logaddexp.reduce(log_zw_all))
    weights = np.exp(log_zw_all - logz)
    # logZ uncertainty: Monte-Carlo over the stochastic volume
    # compression (primary), information heuristic kept for reference:
    logz_err = _bootstrap_logz_err(
        dead_logl, live_logl_np, nlive, batch, n_use,
    )
    ok = weights > 0
    info = float(np.sum(weights[ok] * (all_logl[ok] - logz)))
    logz_err_info = float(np.sqrt(max(info, 0.0) / nlive))

    samples = np.asarray(
        jax.jit(jax.vmap(prior_transform))(jnp.asarray(all_u))
    )
    from .posterior import weighted_to_equal
    posterior = weighted_to_equal(samples, weights)

    # Mode separation + per-mode evidences (MultiNest's multimodal
    # output contract):
    modes = identify_modes(samples, weights)
    nmodes = int(modes.max()) + 1
    mode_logz = np.array([
        float(np.logaddexp.reduce(log_zw_all[modes == k]))
        for k in range(nmodes)
    ])

    return {
        'samples': samples,
        'log_weights': all_logw,
        'log_like': all_logl,
        'weights': weights,
        'logz': logz,
        'logz_err': logz_err,
        'logz_err_info': logz_err_info,
        'posterior': posterior,
        'modes': modes,
        'mode_logz': mode_logz,
        'n_iter': n_use,
        'efficiency': float(np.mean(np.asarray(acc))),
    }
