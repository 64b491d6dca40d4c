"""Fast line-by-line engine: direct Voigt evaluation.

The parity engine (lbl.py) replicates the reference's profile-grid +
scatter-add design (src_c/_extcoeff.c:87-345) for golden-file interop.
This module is the performance path, designed for an accelerator
instead:

* **Gather, not scatter**: the output grid is tiled; every tile
  evaluates all candidate lines (centers within cutoff of the tile) as
  one dense [tile_width, nlines_tile] block -- elementwise work with a
  final contraction over lines.
* **Static core/wing split**: a Voigt profile only needs the full
  Faddeeva function within ~14 Doppler widths of the line center; the
  far wings (the overwhelming majority of (point, line) pairs inside
  the 25 cm-1 cutoff) follow the large-|z| asymptotic series
  w(z) ~ i/(sqrt(pi) z)(1 + 1/2z^2 + 3/4z^4), ~25 flops/pair instead
  of ~300.  The split distance (margin) is a static bound computed
  from the maximum Doppler width, so the partition compiles to two
  fixed-shape passes:
    - core pass: fine tiles (8 points), candidates within margin,
      full Faddeeva, mask |dnu| <= margin;
    - wing pass: coarse tiles (128 points), candidates within cutoff,
      asymptotic series, mask margin < |dnu| <= cutoff.
  The masks make the partition exact pointwise.
* **No profile grid, no width snapping**: each line uses its exact
  Doppler/Lorentz widths (the reference quantizes onto a log grid).
* **Float32-safe by construction**: line strengths span ~40 decades,
  so they are computed in log space and normalized by the running
  maximum; line-center offsets dnu = nu - nu0 are computed from
  (hi, lo) float-pair splits of the wavenumber arrays, so they keep
  full relative precision in float32 (a raw f32 subtraction at
  nu ~ 1e4 cm-1 would have ~1e-3 cm-1 error, a tenth of a Doppler
  width).
* Static tiling: line centers and the output grid are fixed per setup,
  so per-tile candidate ranges are precomputed host-side and the whole
  sampler jits once with fixed shapes.

Physics validation is against an exact float64 wofz evaluation
(tests/test_lbl_tpu.py, rtol 1e-5).
"""
import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as pc
from ..ops.special import wofz_real

__all__ = ['DirectLBL']

_SQRTLN2 = 0.83255461115769775635
_SQRT_PI = 1.7724538509055159
# Large-|z| boundary where the 5-term asymptotic series of w(z) is
# accurate to ~1.3e-6 relative (~2e-7 past the 1.2x margin safety
# factor; verified against scipy.wofz over the full y/x range).
# Round 4 used 3 terms at |z| >= 14; two extra Horner terms (+6
# flops/pair) halve the core/wing split distance, and the core pass's
# full-Faddeeva pairs cost ~10x a wing pair:
_ASYMPTOTIC_Z = 7.0


def _wing_series(u, a):
    """S(u, a) of the 5-term asymptotic Re[w]: Re w = y u S / sqrt(pi),
    u = 1/(x^2+y^2), a = x^2 u."""
    return (
        1.0
        + u * (2.0 * a - 0.5)
        + u**2 * ((12.0 * a - 9.0) * a + 0.75)
        + u**3 * (((120.0 * a - 150.0) * a + 45.0) * a - 1.875)
        + u**4 * ((((1680.0 * a - 2940.0) * a + 1575.0) * a - 262.5)
                  * a + 6.5625)
    )


def _split_hi_lo(values):
    """Split float64 values into (hi, lo) with hi = f32-rounded value.

    Both parts are stored as float64: under x64 the sum is the exact
    input; under default x32 both cast losslessly to f32 and the
    difference-of-splits trick keeps full precision of differences.
    """
    values = np.asarray(values, np.float64)
    hi = values.astype(np.float32).astype(np.float64)
    return hi, values - hi


def _tile_ranges(wn_tiles, lwn, window):
    """Per-tile [start, start+lmax) candidate-line windows (static).

    Returns (starts [ntiles] int32, lmax int) such that every line
    within `window` cm-1 of any point of a tile is inside the tile's
    gather range.  Ranges near the array ends are shifted (not
    truncated) so gathers stay in bounds; distance masks reject the
    extra lines at compute time.
    """
    tile_lo = wn_tiles.min(axis=1) - window
    tile_hi = wn_tiles.max(axis=1) + window
    starts = np.searchsorted(lwn, tile_lo)
    ends = np.searchsorted(lwn, tile_hi, side='right')
    lmax = max(int((ends - starts).max()), 1)
    nlines = len(lwn)
    starts = np.clip(starts, 0, max(nlines - lmax, 0))
    return starts.astype(np.int32), lmax


class DirectLBL:
    """Direct-evaluation LBL sampler over a static wavenumber grid."""

    def __init__(self, lbl, wn=None, tile=128, cutoff=None, tile_core=4,
                 margin=None, tmax_bound=None):
        """
        Parameters
        ----------
        lbl: LineByLine -- provides line data, isotope properties, and
            partition functions (opacity/lbl.py).
        wn: output wavenumber grid (default: the lbl coarse grid).
        tile: wing-pass output tile width.
        cutoff: line-wing cutoff in cm-1 (default: the lbl cutoff).
        tile_core: core-pass tile width (small, so core candidate
            lists stay tight around the margin window).
        margin: core/wing split distance in cm-1 (default: computed
            so |z| >= 14 is guaranteed in the wings for any T up to
            tmax_bound).
        tmax_bound: temperature bound for the static margin (default:
            1.5x the lbl tmax, or 6000 K).
        """
        self.lbl = lbl
        self.wn = np.asarray(wn if wn is not None else lbl.wn, np.float64)
        self.nwave = len(self.wn)
        self.tile = int(tile)
        self.tile_core = int(tile_core)
        self.cutoff = float(cutoff if cutoff is not None else lbl.cutoff)

        # Sort lines by wavenumber (static):
        order = np.argsort(np.asarray(lbl.lwn), kind='stable')
        self.lwn = np.asarray(lbl.lwn, np.float64)[order]
        self.gf = np.asarray(lbl.gf, np.float64)[order]
        self.elow = np.asarray(lbl.elow, np.float64)[order]
        self.isoid = np.asarray(lbl.isoid, np.int32)[order]
        self.nlines = len(self.lwn)

        # Per-line isotope properties:
        self.iso_mass = np.asarray(lbl.iso_mass, np.float64)
        self.iso_ratio = np.asarray(lbl.iso_ratio, np.float64)
        self.iso_spec = np.asarray(lbl.iso_spec_index, np.int32)
        self.iso_imol = np.asarray(lbl.iso_atm_index, np.int32)
        self.nspec = int(lbl.nspec)
        self.mol_radius = np.asarray(lbl.mol_radius, np.float64)
        self.mol_mass = np.asarray(lbl.mol_mass, np.float64)

        # Static core/wing split distance: guarantee |x| >= 14 beyond
        # the margin for the largest possible Doppler HWHM:
        if margin is None:
            if tmax_bound is None:
                tmax = getattr(lbl, 'tmax', None)
                tmax_bound = 1.5 * tmax if tmax and np.isfinite(tmax) \
                    else 6000.0
            fdop_max = np.sqrt(
                2.0 * pc.KB_KERNEL * tmax_bound
                / (pc.AMU_KERNEL * self.iso_mass.min())
            ) / pc.LS_KERNEL
            ad_max = fdop_max * self.lwn.max() * _SQRTLN2
            margin = 1.2 * _ASYMPTOTIC_Z * ad_max / _SQRTLN2
        self.margin = float(min(margin, self.cutoff))

        # Wing tiling (coarse) over the full cutoff window:
        self.ntiles = -(-self.nwave // self.tile)
        self.wn_tiles = self._pad_tiles(self.tile, self.ntiles)
        self.tile_starts, self.lmax = _tile_ranges(
            self.wn_tiles, self.lwn, self.cutoff,
        )
        # Core tiling (fine) over the margin window:
        self.ntiles_core = -(-self.nwave // self.tile_core)
        self.wn_tiles_core = self._pad_tiles(
            self.tile_core, self.ntiles_core,
        )
        self.starts_core, self.lmax_core = _tile_ranges(
            self.wn_tiles_core, self.lwn, self.margin,
        )

        # (hi, lo) float-pair splits keep dnu = nu - nu0 accurate when
        # everything downcasts to float32:
        wn_hi, wn_lo = _split_hi_lo(self.wn_tiles)
        wnc_hi, wnc_lo = _split_hi_lo(self.wn_tiles_core)

        # Dense partition-function grid for jit-safe interpolation
        # (the host iso_pf interpolates per-isotope tables of varying
        # lengths; a uniform resample makes it one vectorized lerp):
        tlo = getattr(lbl, 'tmin', None) or 70.0
        thi = getattr(lbl, 'tmax', None) or 6000.0
        self._pf_t0 = float(tlo)
        n_pf = 512
        self._pf_dt = (float(thi) - float(tlo)) / (n_pf - 1)
        pf_grid_t = np.linspace(float(tlo), float(thi), n_pf)
        pf_dense = np.asarray(lbl.iso_pf(pf_grid_t), np.float64)

        # Pre-pad all static line data into the per-tile window layout
        # [ntiles, lmax] host-side: per-call factors are then computed
        # directly in this layout and the device passes perform no
        # per-tile gathers.
        log_kbase = np.log(
            pc.SIGCTE * self.iso_ratio[self.isoid] * self.gf,
        )
        wing_pad = self._pad_line_windows(
            self.tile_starts, self.lmax, log_kbase,
        )
        core_pad = self._pad_line_windows(
            self.starts_core, self.lmax_core, log_kbase,
        )

        # Line data ships as jit arguments (a pytree), not closure
        # constants: multi-MB HLO literals slow compilation and
        # re-trace on every new engine instance.
        self._tables = {
            'wn_tiles_hi': wn_hi,
            'wn_tiles_lo': wn_lo,
            'wn_core_hi': wnc_hi,
            'wn_core_lo': wnc_lo,
            'iso_mass': self.iso_mass,
            'iso_ratio': self.iso_ratio,
            'iso_spec': self.iso_spec,
            'mol_radius': self.mol_radius,
            'mol_mass': self.mol_mass,
            'iso_pf_grid': pf_dense,
        }
        for key, val in wing_pad.items():
            self._tables['w_' + key] = val
        for key, val in core_pad.items():
            self._tables['c_' + key] = val
        self._jit_cs = jax.jit(self._cross_section)
        self._device_tables = None
        self._sweep = None

    def _pad_line_windows(self, starts, lmax, log_kbase):
        """Static per-tile line windows [ntiles, lmax] (host)."""
        nlines = self.nlines
        lwn = self.lwn
        elow = self.elow
        isoid = self.isoid
        if nlines < lmax:
            npad = lmax - nlines
            # Fake far-away lines: distance masks always reject them.
            lwn = np.concatenate([lwn, np.full(npad, self.wn[-1] + 1e9)])
            elow = np.concatenate([elow, np.zeros(npad)])
            isoid = np.concatenate([isoid, np.zeros(npad, np.int32)])
            log_kbase = np.concatenate([log_kbase, np.full(npad, -700.0)])
        idx = starts[:, None].astype(np.int64) + np.arange(lmax)[None, :]
        lwn_hi, lwn_lo = _split_hi_lo(lwn[idx])
        # Static per-entry Doppler coefficient: inv_ad = inv_dop /
        # sqrt(T) at runtime -- the iso-mass gather happens ONCE here
        # on the host instead of per cell on device:
        k_iso = (
            np.sqrt(2.0 * pc.KB_KERNEL / pc.AMU_KERNEL)
            / pc.LS_KERNEL / np.sqrt(self.iso_mass)
        )
        inv_dop = 1.0 / (k_iso[isoid] * lwn)
        return {
            'lwn_hi': lwn_hi,
            'lwn_lo': lwn_lo,
            'logkb': log_kbase[idx],
            'elow': elow[idx],
            'iso': isoid[idx],
            'inv_dop': inv_dop[idx],
        }

    def _pad_tiles(self, tile, ntiles):
        # Pad with the last grid value: padded outputs are sliced off
        # after the flatten, and repeating a real value keeps the
        # static candidate windows tight (a far-away sentinel would
        # blow up the last tile's gather range).
        npad = ntiles * tile
        wn_pad = np.concatenate([
            self.wn, np.full(npad - self.nwave, self.wn[-1]),
        ])
        return wn_pad.reshape(ntiles, tile)

    def tables(self):
        """Line-data pytree, cached on device after the first use
        (avoids re-shipping MBs of line data every call)."""
        if self._device_tables is None:
            self._device_tables = jax.device_put(self._tables)
        return self._device_tables

    # ------------------------------------------------------------------

    def _layer_widths_t(self, tables, temp, densities):
        """Per-isotope Lorentz HWHM and Doppler factor (jnp)."""
        iso_mass = tables['iso_mass']
        mol_radius = tables['mol_radius']
        mol_mass = tables['mol_mass']
        fdop = jnp.sqrt(
            2.0 * pc.KB_KERNEL * temp / pc.AMU_KERNEL
        ) / pc.LS_KERNEL / jnp.sqrt(iso_mass)
        flor = jnp.sqrt(
            2.0 * pc.KB_KERNEL * temp / np.pi / pc.AMU_KERNEL
        ) / pc.LS_KERNEL
        coll = (
            mol_radius[self.iso_imol][:, None] + mol_radius[None, :]
        )
        alphal = flor * jnp.sum(
            densities[None, :] * coll**2
            * jnp.sqrt(1.0 / iso_mass[:, None] + 1.0 / mol_mass[None, :]),
            axis=1,
        )
        return alphal, fdop

    def _window_factors(self, tables, prefix, temp, alphal_iso,
                        fdop_iso, iso_pf):
        """Per-call line factors in the padded [ntiles, lmax] layout:
        (log_k, inv_ad, y).

        No device gathers: the iso-mass Doppler coefficient is a static
        per-entry table (inv_ad = inv_dop / sqrt(T)), and the per-cell
        [niso] scalars broadcast through a static where-chain over iso
        ids."""
        iso = tables[prefix + 'iso']
        lwn = tables[prefix + 'lwn_hi']   # f32 precision: fine for
        elow = tables[prefix + 'elow']    # strengths and widths
        log_pf = jnp.log(iso_pf)
        alphal_e = jnp.zeros_like(lwn)
        logpf_e = jnp.zeros_like(lwn)
        for k in range(len(self.iso_mass)):
            m = iso == k
            alphal_e = alphal_e + jnp.where(m, alphal_iso[k], 0.0)
            logpf_e = logpf_e + jnp.where(m, log_pf[k], 0.0)
        log_k = (
            tables[prefix + 'logkb']
            - pc.EXPCTE * elow / temp
            + jnp.log(-jnp.expm1(-pc.EXPCTE * lwn / temp))
            - logpf_e
        )
        inv_ad = tables[prefix + 'inv_dop'] / jnp.sqrt(temp)
        y = alphal_e * inv_ad
        return log_k, inv_ad, y

    def _spec_contract(self, tables, prefix, contrib, iso_row):
        """[tile, lmax] pair contributions -> [nspec, tile]."""
        if self.nspec == 1:
            return jnp.sum(contrib, axis=1)[None, :]
        l_spec = tables['iso_spec'][iso_row]
        spec_onehot = (
            l_spec[None, :] == jnp.arange(self.nspec)[:, None]
        )
        return jnp.einsum(
            'wl,sl->sw', contrib, spec_onehot.astype(contrib.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )

    def _wing_tile(self, tables, args):
        """Wing pass for one tile: 5-term asymptotic Re[w(z)],
        masked to margin < |dnu| <= cutoff.

        Uses the real-arithmetic Horner form of
        w(z) ~ (i/sqrt(pi)) sum_k (2k-1)!!/2^k z^-(2k+1):
            Re w = y u S(u, a) / sqrt(pi),
            a = x^2 u,  u = 1/(x^2 + y^2)   (see _wing_series).
        """
        wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, iso_row = args
        dwn = (
            (wn_hi[:, None] - lwn_hi[None, :])
            + (wn_lo[:, None] - lwn_lo[None, :])
        )
        x2 = (dwn * inv_ad[None, :])**2
        u = 1.0 / (x2 + y2[None, :])
        a = x2 * u
        s = _wing_series(u, a)
        adwn = jnp.abs(dwn)
        mask = (adwn > self.margin) & (adwn <= self.cutoff)
        contrib = jnp.where(mask, c1[None, :] * u * s, 0.0)
        return self._spec_contract(tables, 'w_', contrib, iso_row)

    def _core_tile(self, tables, args):
        """Core pass for one tile: full Faddeeva, |dnu| <= margin."""
        wn_hi, wn_lo, lwn_hi, lwn_lo, scale, y, inv_ad, iso_row = args
        dwn = (
            (wn_hi[:, None] - lwn_hi[None, :])
            + (wn_lo[:, None] - lwn_lo[None, :])
        )
        x = dwn * inv_ad[None, :]
        yy = jnp.broadcast_to(y[None, :], x.shape)
        voigt = wofz_real(x, yy)
        mask = jnp.abs(dwn) <= self.margin
        contrib = jnp.where(mask, voigt * scale[None, :], 0.0)
        return self._spec_contract(tables, 'c_', contrib, iso_row)

    def _cell_factors(self, tables, temp, densities, iso_pf):
        """Per-cell line factors for both passes, kmax-normalized."""
        temp = jnp.asarray(temp)
        alphal_iso, fdop_iso = self._layer_widths_t(
            tables, temp, densities,
        )
        logk_w, inv_ad_w, y_w = self._window_factors(
            tables, 'w_', temp, alphal_iso, fdop_iso, iso_pf,
        )
        logk_c, inv_ad_c, y_c = self._window_factors(
            tables, 'c_', temp, alphal_iso, fdop_iso, iso_pf,
        )
        # Global strength normalization (float32-safe: weights in
        # [0, 1], the common magnitude factored out):
        log_kmax = jnp.maximum(jnp.max(logk_w), jnp.max(logk_c))
        kmax = jnp.exp(log_kmax)
        scale_w = jnp.exp(logk_w - log_kmax) * inv_ad_w / _SQRT_PI
        scale_c = jnp.exp(logk_c - log_kmax) * inv_ad_c / _SQRT_PI
        # Wing fold: contrib = Re[w]*scale with Re[w] = y u S / sqrt(pi)
        # => c1 = y * scale / sqrt(pi):
        c1_w = y_w * scale_w * (1.0 / _SQRT_PI)
        y2_w = y_w * y_w
        return {
            'kmax': kmax,
            'c1_w': c1_w, 'y2_w': y2_w, 'inv_ad_w': inv_ad_w,
            'scale_c': scale_c, 'y_c': y_c, 'inv_ad_c': inv_ad_c,
        }

    def _cross_section_batch(self, tables, temps, densities, iso_pfs):
        """sigma [ncell, nspec, nwave] over a batch of cells."""
        return jax.vmap(
            self._cross_section, in_axes=(None, 0, 0, 0),
        )(tables, temps, densities, iso_pfs)

    def _cross_section(self, tables, temp, densities, iso_pf):
        """sigma [nspec, nwave] (cm2/molec) at one (T, densities) cell."""
        fac = self._cell_factors(tables, temp, densities, iso_pf)
        kmax = fac['kmax']
        c1_w, y2_w, inv_ad_w = fac['c1_w'], fac['y2_w'], fac['inv_ad_w']
        scale_c, y_c, inv_ad_c = (
            fac['scale_c'], fac['y_c'], fac['inv_ad_c'],
        )

        # vmap (not lax.map/scan): the batched form fuses the
        # elementwise chain into the final contraction without
        # materializing the [ntiles, tile, lmax] intermediate.
        wing = jax.vmap(
            lambda a: self._wing_tile(tables, a),
        )((tables['wn_tiles_hi'], tables['wn_tiles_lo'],
           tables['w_lwn_hi'], tables['w_lwn_lo'],
           c1_w, y2_w, inv_ad_w, tables['w_iso']))
        core = jax.vmap(
            lambda a: self._core_tile(tables, a),
        )((tables['wn_core_hi'], tables['wn_core_lo'],
           tables['c_lwn_hi'], tables['c_lwn_lo'],
           scale_c, y_c, inv_ad_c, tables['c_iso']))

        # [ntiles, nspec, tile] -> [nspec, nwave]:
        sigma = (
            jnp.moveaxis(wing, 1, 0).reshape(self.nspec, -1)[
                :, :self.nwave]
            + jnp.moveaxis(core, 1, 0).reshape(self.nspec, -1)[
                :, :self.nwave]
        )
        return sigma * kmax

    def _iso_pf_t(self, tables, temp):
        """Jit-safe per-isotope partition functions at scalar temp."""
        grid = tables['iso_pf_grid']
        n_pf = grid.shape[1]
        x = (temp - self._pf_t0) / self._pf_dt
        i0 = jnp.clip(x.astype(jnp.int32), 0, n_pf - 2)
        w = jnp.clip(x - i0, 0.0, 1.0)
        return grid[:, i0] * (1.0 - w) + grid[:, i0 + 1] * w

    def extinction_fn(self):
        """Build a pure fn(temp [nlayers], dens [nlayers, nmol]) ->
        ec [nlayers, nwave] (cm-1), jit/vmap-safe.

        This is what lets live line-by-line opacity run inside the
        jitted retrieval forward (the reference forks a process pool
        per evaluation, pyrat/line_by_line.py:231-248).
        """
        tables = self.tables()
        imol_of_spec = np.array([
            self.iso_imol[np.argmax(self.iso_spec == s)]
            for s in range(self.nspec)
        ])

        def ec_fn(temp, dens):
            pf = jax.vmap(
                lambda t: self._iso_pf_t(tables, t),
            )(temp)                            # [nl, niso]
            cs = self._cross_section_batch(
                tables, temp, dens, pf,
            )                                  # [nl, nspec, nwave]
            return jnp.sum(
                cs * dens[:, imol_of_spec][:, :, None], axis=1,
            )

        return ec_fn

    # ------------------------------------------------------------------

    def cross_section(self, temp, densities, iso_pf=None):
        """sigma [nspec, nwave] at one cell (jitted)."""
        if iso_pf is None:
            iso_pf = self.lbl.iso_pf(np.atleast_1d(temp))[:, 0]
        return self._jit_cs(
            self.tables(),
            jnp.asarray(temp, jnp.float32),
            jnp.asarray(densities, jnp.float32),
            jnp.asarray(iso_pf, jnp.float32),
        )

    def tabulate(self, temps, press, vmr, block=64, max_out_bytes=2**31):
        """Cross-section table [ntemp, nlayers, nwave] for one species.

        The device replacement for the reference's forked process pool
        over (T, layer) grid cells (pyrat/extinction.py:100-119).  All
        cell inputs are precomputed host-side once, the whole sweep runs
        as one (or a few) jitted `lax.map` calls over `block`-cell
        vmapped batches that keep the output on device, and results come
        back in one fetch per superblock -- no per-block host round
        trips.

        Parameters
        ----------
        block: cells evaluated per vmapped batch.
        max_out_bytes: device-memory budget for one superblock's output
            [nblocks, block, nspec, nwave] f32; bigger tables are split
            into sequential superblock dispatches (still pipelined:
            nothing blocks until the final fetches).
        """
        temps = np.asarray(temps)
        press = np.asarray(press)
        vmr = np.asarray(vmr)
        ntemp, nlayers = len(temps), len(press)
        ncells = ntemp * nlayers

        cells_t = np.repeat(temps, nlayers)
        cells_p = np.tile(press, ntemp)
        cells_vmr = np.tile(vmr, (ntemp, 1))
        dens = cells_vmr * (
            cells_p[:, None] * pc.bar / (pc.k * cells_t[:, None])
        )
        pf = self.lbl.iso_pf(cells_t).T  # [ncells, niso]

        block = max(1, int(block))
        nblocks = -(-ncells // block)
        npad = nblocks * block - ncells
        if npad:
            cells_t = np.pad(cells_t, (0, npad), mode='edge')
            dens = np.pad(dens, ((0, npad), (0, 0)), mode='edge')
            pf = np.pad(pf, ((0, npad), (0, 0)), mode='edge')
        t_all = cells_t.reshape(nblocks, block).astype(np.float32)
        d_all = dens.reshape(nblocks, block, -1).astype(np.float32)
        pf_all = pf.reshape(nblocks, block, -1).astype(np.float32)

        if self._sweep is None:
            self._sweep = jax.jit(
                lambda tables, t, d, p: jax.lax.map(
                    lambda a: self._cross_section_batch(tables, *a),
                    (t, d, p),
                ),
            )
        tables = self.tables()

        out_block_bytes = block * self.nspec * self.nwave * 4
        super_nb = max(1, min(nblocks, int(max_out_bytes // out_block_bytes)))
        chunks = []
        for lo in range(0, nblocks, super_nb):
            hi = min(lo + super_nb, nblocks)
            chunks.append(self._sweep(
                tables,
                jnp.asarray(t_all[lo:hi]),
                jnp.asarray(d_all[lo:hi]),
                jnp.asarray(pf_all[lo:hi]),
            ))
        out = np.concatenate(
            [np.asarray(c, np.float32) for c in chunks], axis=0,
        ).reshape(nblocks * block, self.nspec, self.nwave)[:ncells]
        return out[:, 0].reshape(ntemp, nlayers, self.nwave) \
            if self.nspec == 1 else \
            out.reshape(ntemp, nlayers, self.nspec, self.nwave) \
            .transpose(2, 0, 1, 3)
