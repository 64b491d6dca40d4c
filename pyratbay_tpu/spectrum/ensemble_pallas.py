"""Ensemble transit RT: one fused Pallas (Triton) kernel per batch.

The XLA lowering of the batched transit RT writes the summed
extinction, writes `depth = path2 @ ec` as a batched [L, L] x [L, W]
product, then reads depth back for the exp, the early-stop masks and
the trapezoid: about four full [B, L, W] device-memory round trips.
This kernel reads each extinction contribution once and writes only
the [B, W] spectrum.  One program handles one (chain, wave tile):

* the un-summed contributions are loaded and added in registers,
  with the layer axis padded to a power of two by masked loads (no
  padded copy in device memory);
* rank-1 sources (Rayleigh, power-law hazes, gray clouds) arrive as
  (layer column, wave row) pairs and CIA as per-chain temperature
  weights against its small chain-invariant table, so their dense
  [B, L, W] buffers never exist;
* the chord contraction is one [LP, LP] x [LP, WT] dot at
  Precision.HIGHEST (an unset precision lowers to TF32 on the GPU);
* the early-stop/exp/deck-splice/trapezoid epilogue runs on the tile
  in registers.

`transit_spectrum_ensemble` picks the kernel when lowering for a CUDA
device and the plain XLA reference (`transit_spectrum_reference`)
otherwise.  Reference semantics: pyratbay/src_c/_trapezoid.c:238-276,
pyratbay/spectrum/radiative_transfer.py:23-73.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import rt

__all__ = [
    'transit_spectrum_ensemble', 'transit_spectrum_reference',
    'dense_extinction',
]

_HIGHEST = jax.lax.Precision.HIGHEST

# Launch constants, measured on an H100 at the flagship shape
# (1,024 chains x 51 layers x 3,209 wavenumbers; PERF.md).  Tiles of
# more than 32 elements per thread ran 10-30x slower there:
WAVE_TILE = 32
NUM_WARPS = 4


def _pow2(n):
    """Smallest power of two >= max(n, 16) (Triton block sizes; its
    dot also needs every operand dimension >= 16)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def dense_extinction(ec_parts, cia_w=None, cia_tab=None, r1_cols=None,
                     r1_rows=None):
    """[B, L, W] extinction from the kernel's operand classes: dense
    parts + rank-1 (column x row) pairs + CIA weights x table."""
    ec = None
    for part in ec_parts:
        ec = part if ec is None else ec + part
    if r1_cols is not None:
        r1 = jnp.einsum('brl,brw->blw', r1_cols, r1_rows,
                        precision=_HIGHEST)
        ec = r1 if ec is None else ec + r1
    if cia_w is not None:
        cia = jnp.einsum('blk,kw->blw', cia_w, jnp.asarray(cia_tab),
                         precision=_HIGHEST)
        ec = cia if ec is None else ec + cia
    return ec


def _prep_chain(radius, rstar, itop, ibottom, deck_itop, deck_rsurf):
    """Per-chain kernel operands (vmappable): the scalar 8-vector
    (itop, ibottom, deck row, deck on/off, deck surface weight,
    1/rstar^2, r[itop]^2, 0) and the radius, h_j and h_{j-1} rows with
    the deck fix-ups applied."""
    dt = radius.dtype
    nlayers = radius.shape[0]
    h = radius[1:] - radius[:-1]              # [nlayers-1], negative
    itop = jnp.asarray(itop, dt)
    ibottom = jnp.asarray(ibottom, dt)
    if deck_rsurf is not None:
        j = deck_itop - 1
        r_j = jnp.take(radius, jnp.clip(j, 0, nlayers - 1))
        r_j1 = jnp.take(radius, jnp.clip(j + 1, 0, nlayers - 1))
        w_surf = ((r_j - deck_rsurf) / (r_j - r_j1)).astype(dt)
        apply_deck = (jnp.asarray(deck_itop, dt) > itop).astype(dt)
        h = jnp.where(
            jnp.arange(nlayers - 1) == j,
            jnp.where(
                apply_deck > 0.5, jnp.asarray(deck_rsurf, dt) - r_j,
                h[jnp.clip(j, 0, nlayers - 2)],
            ),
            h,
        )
        deck_row = jnp.asarray(deck_itop, dt)
    else:
        w_surf = jnp.asarray(0.0, dt)
        apply_deck = jnp.asarray(0.0, dt)
        deck_row = jnp.asarray(-1.0, dt)
    h_row = jnp.pad(h, (0, 1))                # h_j at row j
    hprev_row = jnp.pad(h, (1, 0))            # h_{j-1} at row j
    r_itop2 = jnp.take(
        radius, jnp.clip(itop.astype(jnp.int32), 0, nlayers - 1)) ** 2
    inv_rstar2 = 1.0 / jnp.asarray(rstar, dt) ** 2
    scal = jnp.stack([
        itop, ibottom, deck_row, apply_deck,
        w_surf, inv_rstar2, r_itop2, jnp.asarray(0.0, dt),
    ])
    return scal, radius, h_row, hprev_row


def _epilogue(depth, rad, h, hprev, scal, maxdepth):
    """depth [LP, WT] -> spectrum [WT]: early stop, exp, deck splice
    and the masked trapezoid as per-row coefficients (the pair sum
    sum_i 0.5 h_i (f_i + f_{i+1}) over itop <= i < ideep equals
    sum_j f_j 0.5 (h_j m_j + h_{j-1} m_{j-1}), which needs no shifted
    rows).  Padded rows (>= nlayers) hold zero depth, radius and h and
    never fall inside [itop, ibottom)."""
    (itop, ibottom, deck_itop, apply_deck, w_surf, inv_rstar2,
     r_itop2) = scal
    dt = depth.dtype
    lp = depth.shape[0]
    rows = jnp.arange(lp, dtype=jnp.int32).astype(dt)[:, None]  # [LP, 1]
    in_range = (rows >= itop) & (rows < ibottom)
    exceeded = in_range & (depth > maxdepth)
    first = jnp.min(jnp.where(exceeded, rows, float(lp)), axis=0)
    ideep = jnp.where(first < float(lp), first, ibottom - 1.0)[None, :]

    integ = jnp.exp(-depth) * rad[:, None]
    # Cloud-deck surface: row deck_itop becomes the interpolation
    # between rows deck_itop-1 and deck_itop at the surface radius.
    integ_j = jnp.sum(jnp.where(rows == deck_itop - 1.0, integ, 0.0),
                      axis=0)
    integ_j1 = jnp.sum(jnp.where(rows == deck_itop, integ, 0.0), axis=0)
    integ_surf = integ_j * (1.0 - w_surf) + integ_j1 * w_surf
    integ = jnp.where((rows == deck_itop) & (apply_deck > 0.5),
                      integ_surf[None, :], integ)

    m = (in_range & (rows < ideep)).astype(dt)
    mp = ((rows >= itop + 1.0) & (rows <= ideep)).astype(dt)
    coef = 0.5 * (h[:, None] * m + hprev[:, None] * mp)
    integral = jnp.sum(integ * coef, axis=0)
    return (r_itop2 + 2.0 * integral) * inv_rstar2


def _kernel(scal_ref, path2_ref, rad_ref, h_ref, hprev_ref, *refs,
            n_parts, n_r1, ncia, nlayers, nwave, lp, wt, kp, maxdepth):
    refs = list(refs)
    out_ref = refs.pop()
    part_refs = refs[:n_parts]
    refs = refs[n_parts:]
    b = pl.program_id(0)
    w0 = pl.program_id(1) * wt
    row_ok = jnp.arange(lp, dtype=jnp.int32) < nlayers
    col_ok = w0 + jnp.arange(wt, dtype=jnp.int32) < nwave
    tile_ok = row_ok[:, None] & col_ok[None, :]
    layers = pl.ds(0, lp)
    waves = pl.ds(w0, wt)

    dt = out_ref.dtype
    ec = jnp.zeros((lp, wt), dt)
    for ref in part_refs:
        ec += plgpu.load(ref.at[b, layers, waves], mask=tile_ok, other=0.0)
    if n_r1:
        col_ref, row_ref = refs[:2]
        refs = refs[2:]
        for r in range(n_r1):
            col = plgpu.load(col_ref.at[b, r, layers], mask=row_ok,
                             other=0.0)
            row = plgpu.load(row_ref.at[b, r, waves], mask=col_ok,
                             other=0.0)
            ec += col[:, None] * row[None, :]
    if ncia:
        ciaw_ref, ciat_ref = refs
        k_ok = jnp.arange(kp, dtype=jnp.int32) < ncia
        cia_w = plgpu.load(ciaw_ref.at[b, layers, pl.ds(0, kp)],
                           mask=row_ok[:, None] & k_ok[None, :],
                           other=0.0)
        cia_t = plgpu.load(ciat_ref.at[pl.ds(0, kp), waves],
                           mask=k_ok[:, None] & col_ok[None, :],
                           other=0.0)
        ec += jnp.dot(cia_w, cia_t, precision=_HIGHEST,
                      preferred_element_type=dt)

    path2 = plgpu.load(path2_ref.at[b, layers, layers],
                       mask=row_ok[:, None] & row_ok[None, :], other=0.0)
    depth = jnp.dot(path2, ec, precision=_HIGHEST,
                    preferred_element_type=dt)
    rad = plgpu.load(rad_ref.at[b, layers], mask=row_ok, other=0.0)
    h = plgpu.load(h_ref.at[b, layers], mask=row_ok, other=0.0)
    hprev = plgpu.load(hprev_ref.at[b, layers], mask=row_ok, other=0.0)
    scal = tuple(scal_ref[b, i] for i in range(7))
    spec = _epilogue(depth, rad, h, hprev, scal, maxdepth)
    plgpu.store(out_ref.at[b, waves], spec, mask=col_ok)


def _transit_kernel(ec_parts, path, radius, rstar, itop, ibottom,
                    deck_itop, deck_rsurf, cia_w, cia_tab, r1_cols,
                    r1_rows, *, maxdepth, interpret):
    nb, nlayers = radius.shape
    if ec_parts:
        nwave = ec_parts[0].shape[2]
    elif r1_rows is not None:
        nwave = r1_rows.shape[2]
    else:
        nwave = cia_tab.shape[1]
    dt = radius.dtype
    path = path.astype(dt)
    path2 = (jnp.pad(path, ((0, 0), (0, 0), (1, 0)))
             + jnp.pad(path, ((0, 0), (0, 0), (0, 1))))   # [B, L, L]
    scal, rad, h, hprev = jax.vmap(
        _prep_chain,
        in_axes=(0, None, 0, 0,
                 None if deck_itop is None else 0,
                 None if deck_rsurf is None else 0),
    )(radius, rstar, itop, ibottom, deck_itop, deck_rsurf)

    operands = [scal, path2, rad, h, hprev]
    operands += [p.astype(dt) for p in ec_parts]
    n_r1 = 0
    if r1_cols is not None:
        n_r1 = r1_cols.shape[1]
        operands += [r1_cols.astype(dt), r1_rows.astype(dt)]
    ncia = 0
    if cia_w is not None:
        ncia = cia_tab.shape[0]
        operands += [cia_w.astype(dt), jnp.asarray(cia_tab, dt)]

    wt = WAVE_TILE
    kernel = functools.partial(
        _kernel, n_parts=len(ec_parts), n_r1=n_r1, ncia=ncia,
        nlayers=nlayers, nwave=nwave, lp=_pow2(nlayers), wt=wt,
        kp=_pow2(ncia), maxdepth=float(maxdepth),
    )
    return pl.pallas_call(
        kernel,
        grid=(nb, pl.cdiv(nwave, wt)),
        out_shape=jax.ShapeDtypeStruct((nb, nwave), dt),
        backend='triton',
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name='transit_rt_ensemble',
    )(*operands)


def transit_spectrum_reference(ec_parts, path, radius, rstar, itop,
                               ibottom, deck_itop=None, deck_rsurf=None,
                               cia_w=None, cia_tab=None, r1_cols=None,
                               r1_rows=None, *, maxdepth=np.inf):
    """Plain XLA version of the kernel: dense extinction, then the
    per-chain transit_depth + transmission_spectrum under vmap."""
    ec = dense_extinction(ec_parts, cia_w, cia_tab, r1_cols, r1_rows)

    def one(ec_i, path_i, rad_i, itop_i, ibot_i, ditop, dsurf):
        depth, ideep = rt.transit_depth(ec_i, path_i, maxdepth, itop_i,
                                        ibot_i)
        return rt.transmission_spectrum(
            depth, ideep, rad_i, rstar, itop_i,
            deck_rsurf=dsurf, deck_itop=ditop,
        )

    deck_axis = None if deck_itop is None else 0
    return jax.vmap(one, in_axes=(0, 0, 0, 0, 0, deck_axis, deck_axis))(
        ec, path, radius, itop, ibottom, deck_itop, deck_rsurf)


def transit_spectrum_ensemble(
        ec_parts, path, radius, rstar, itop, ibottom,
        deck_itop=None, deck_rsurf=None, cia_w=None, cia_tab=None,
        r1_cols=None, r1_rows=None, *, maxdepth=np.inf, interpret=False,
    ):
    """Batched transit (Rp/Rs)^2 spectra.

    Parameters
    ----------
    ec_parts: list of [B, L, W] extinction contributions (summed here).
    path: [B, L, L-1] chord matrices (transit_path_matrix).
    radius: [B, L] (same normalization as rstar).
    rstar: scalar.
    itop, ibottom: [B] top row and one-past-bottom row.
    deck_itop, deck_rsurf: [B] opaque-deck surfaces, or None.
    cia_w: [B, L, K] CIA temperature x density weights, cia_tab:
        [K, W] their tables (all CIA sources concatenated along K).
    r1_cols: [B, R, L], r1_rows: [B, R, W] rank-1 sources.
    maxdepth: early-stop optical depth.
    interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns spectrum [B, W].  Lowered for a CUDA device this is the
    Triton kernel; elsewhere the XLA reference.  A kernel that fails
    to compile for the GPU raises; there is no fallback.
    """
    args = (list(ec_parts), path, radius, rstar, itop, ibottom,
            deck_itop, deck_rsurf, cia_w, cia_tab, r1_cols, r1_rows)
    kernel = functools.partial(_transit_kernel, maxdepth=maxdepth,
                               interpret=interpret)
    if interpret:
        return kernel(*args)
    reference = functools.partial(transit_spectrum_reference,
                                  maxdepth=maxdepth)
    return jax.lax.platform_dependent(*args, cuda=kernel,
                                      default=reference)
