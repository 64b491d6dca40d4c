"""Collision-induced absorption from tabulated cross sections.

At setup: read the table, cubic-spline resample onto the working
wavenumber grid (host-side, once), normalize amagat^-N -> (molec cm-3)^-N,
and precompute dCS/dT slopes.  At runtime: a single vectorized linear
interpolation in temperature (device-side).
Reference behavior: pyratbay/opacity/cia.py.
"""
import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as pc
from ..io import io as pio
from ..ops.interp import second_deriv_ref, splinterp, lin_interp_trow

__all__ = ['CIA']


class CIA:
    """One CIA table (e.g. H2-H2 or H2-He)."""

    def __init__(self, cia_file, wn=None):
        self.cia_file = cia_file
        absorption, species, temps, tab_wn = pio.read_cs(cia_file)

        self.species = species
        self.nspec = len(species)
        self.name = 'CIA ' + '-'.join(species)
        self.npars = 0
        self.pnames = []
        self.texnames = []
        self.pars = []

        t_sort = np.argsort(temps)
        absorption = absorption[t_sort]
        self.temps = temps[t_sort]
        self.ntemp = len(self.temps)
        self.tmin = self.temps.min()
        self.tmax = self.temps.max()

        if wn is None:
            self.wn = tab_wn
            cross_section = absorption
        else:
            self.wn = np.asarray(wn)
            # Spline-resample each temperature row onto the working grid.
            # (second_deriv_ref reproduces the reference's spline-tension
            # quirk; see ops/interp.py.)
            sorted_wn = self.wn[::-1] if self.wn[1] < self.wn[0] else self.wn
            sorted_tab = tab_wn[::-1] if tab_wn[1] < tab_wn[0] else tab_wn
            cross_section = np.zeros((self.ntemp, len(self.wn)))
            for j in range(self.ntemp):
                y2 = second_deriv_ref(absorption[j], sorted_tab)
                cross_section[j] = splinterp(
                    absorption[j], sorted_tab, y2, sorted_wn, extrap=0.0,
                )
            if self.wn[1] < self.wn[0]:
                cross_section = np.fliplr(cross_section)
        self.nwave = len(self.wn)

        # Keep the table in amagat^-N units: the values are O(1e-7),
        # float32-safe; the (molec cm-3)^-N normalization (~1e-44 for
        # pairs, below the f32 subnormal range) is applied only in the
        # float64 cross_section API, while extinction() works with
        # amagat-normalized densities throughout.
        self.tab_cs_amagat = cross_section
        self.tab_cross_section = cross_section / pc.amagat**self.nspec

        # Wavenumber span actually covered by the table:
        good = (self.wn >= tab_wn.min()) & (self.wn <= tab_wn.max())
        self._wn_lo = int(np.where(good)[0][0])
        self._wn_hi = int(np.where(good)[0][-1]) + 1
        self._dcs_dt = (
            np.diff(self.tab_cross_section, axis=0)
            / np.expand_dims(np.ediff1d(self.temps), 1)
        )
        self._dcs_dt_amagat = (
            np.diff(cross_section, axis=0)
            / np.expand_dims(np.ediff1d(self.temps), 1)
        )
        self.mol = species

    def cross_section(self, temperature):
        """CS (cm-1 (molec cm-3)^-N): T [nlayers] -> [nlayers, nwave];
        a scalar T gives [nwave] (reference cia.py:127-160).

        Temperatures are clamped into the tabulated range; range
        violations must be rejected by the caller (temp-bounds guard)
        to preserve the reference's sampling semantics.
        """
        temp = jnp.clip(jnp.asarray(temperature), self.tmin, self.tmax)
        scalar = temp.ndim == 0
        cs = lin_interp_trow(
            self.tab_cross_section, self.temps, self._dcs_dt,
            jnp.atleast_1d(temp), self._wn_lo, self._wn_hi,
        )
        return cs[0] if scalar else cs

    def extinction(self, temperature, densities):
        """EC (cm-1): densities [nlayers, nspec] of the colliding pair;
        scalar T + densities [nspec] give a single layer [nwave].

        Evaluated in amagat-normalized units so every intermediate is
        O(1)-ranged and float32-safe.

        The T-lerp and the density product collapse into ONE matmul
        against the table: ec = (w_t * dens_prod).T @ table, where w_t
        holds the two-hot lerp weights per layer.  The forward model is
        HBM-bandwidth-bound, so the fewer [nlayers, nwave] buffers the
        better: this writes exactly one (the output), vs the
        base+slope+lerp+mask+product chain of the generic
        lin_interp_trow path (round-3 profiling: 5.5 -> ~1 MB/forward).
        """
        temp = jnp.clip(jnp.asarray(temperature), self.tmin, self.tmax)
        scalar = temp.ndim == 0
        temp = jnp.atleast_1d(temp)
        temps = jnp.asarray(self.temps)
        tlo = jnp.clip(
            jnp.searchsorted(temps, temp, side='right') - 1,
            0, self.ntemp - 2,
        )
        w_hi = (temp - temps[tlo]) / (temps[tlo + 1] - temps[tlo])
        t_idx = jnp.arange(self.ntemp)[:, None]
        w_t = (
            (t_idx == tlo[None, :]) * (1.0 - w_hi)[None, :]
            + (t_idx == tlo[None, :] + 1) * w_hi[None, :]
        )                                              # [ntemp, nlayers]
        dens_amagat = jnp.atleast_2d(jnp.asarray(densities)) / pc.amagat
        dens_prod = jnp.prod(dens_amagat, axis=1)      # [nlayers]
        # Table columns outside the tabulated wavenumber span are
        # exactly zero (splinterp extrap=0 at setup), so no runtime
        # range mask is needed:
        ec = jnp.matmul(
            (w_t * dens_prod[None, :]).T, jnp.asarray(self.tab_cs_amagat),
            precision=jax.lax.Precision.HIGHEST,
        )
        return ec[0] if scalar else ec

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Collision-induced absorption: {}', self.name)
        fw.write('Species: {}', list(self.species))
        fw.write(
            'Temperature range: {:.1f} -- {:.1f} K ({:d} samples)',
            float(self.tmin), float(self.tmax), self.ntemp,
        )
        fw.write('Wavenumber samples (nwave): {:d}', self.nwave)
        return fw.text
