"""Line-sampled (tabulated) cross-section opacity.

Loads npz cross-section tables [nspec, ntemp, nlayers, nwave], optionally
re-interpolated in pressure/temperature at load time, and provides the
runtime temperature interpolation as one fused gather + einsum: the device
replacement for the reference's C interp_ec triple loop
(src_c/_extcoeff.c:367-472, pyratbay/opacity/line_sampling.py).
"""
import numpy as np
import scipy.interpolate as sip
import jax
import jax.numpy as jnp

from ..io import io as pio

__all__ = ['LineSample', 'interpolate_opacity', 'wn_mask_tol']


def wn_mask_tol(wn, wn_min, wn_max, tol=1.0e-8):
    """Range mask with edge tolerance (reference spec_tools.py:778-814)."""
    mask = (wn >= wn_min) & (wn <= wn_max)
    if np.sum(mask) < 2:
        min_dwn = max_dwn = 0.0
    else:
        min_dwn = np.abs(np.ediff1d(wn[mask][0:2]))
        max_dwn = np.abs(np.ediff1d(wn[mask][-2:]))
    return (wn >= wn_min - min_dwn * tol) & (wn <= wn_max + max_dwn * tol)


def interpolate_opacity(
        cs_file, temperature=None, pressure=None, wn_mask=None, wl_thinning=1,
    ):
    """Load a cross-section table, re-gridded in log-opacity space.

    Pressure/temperature resampling uses linear interpolation of
    log(cs) with edge-value extrapolation (reference
    tools/tools.py:1026-1109); no-op when grids already match to 1%.
    """
    _, temp, press, wn = pio.read_opacity(cs_file, extract='arrays')
    logp_table = np.log(press)
    if wn_mask is None:
        wn_mask = np.ones(len(wn), bool)

    resample_p = (
        pressure is not None
        and (
            len(press) != len(pressure)
            or np.any(np.abs(1.0 - press / pressure) > 0.01)
        )
    )
    resample_t = (
        temperature is not None
        and (
            len(temp) != len(temperature)
            or np.any(np.abs(1.0 - temp / temperature) > 0.01)
        )
    )

    cross_section = pio.read_opacity(cs_file, extract='opacity')[:, :, wn_mask]
    cross_section = cross_section[:, :, ::wl_thinning]
    if not resample_p and not resample_t:
        return cross_section

    log_cs = np.log(cross_section)
    log_cs[~np.isfinite(log_cs)] = -230.0
    if resample_p:
        logp = np.log(pressure)
        interp = sip.interp1d(
            logp_table, log_cs, axis=1, kind='slinear',
            bounds_error=False, fill_value=(log_cs[:, 0], log_cs[:, -1]),
        )
        log_cs = interp(logp)
    if resample_t:
        interp = sip.interp1d(
            temp, log_cs, axis=0, kind='slinear',
            bounds_error=False, fill_value=(log_cs[0], log_cs[-1]),
        )
        log_cs = interp(temperature)
    return np.exp(log_cs)


class LineSample:
    """Tabulated cross sections with runtime temperature interpolation."""

    name = 'line sampling'

    def __init__(
            self, cs_files, pressure=None, temperature=None,
            min_wn=0.0, max_wn=np.inf, wl_thinning=1,
            isotope_ratios=None,
        ):
        """
        Parameters
        ----------
        cs_files: str or list of str -- npz cross-section tables.
        pressure: 1D array (bar) -- target pressure grid (else tabulated).
        temperature: 1D array (K) -- target temperature grid.
        min_wn/max_wn: wavenumber trim bounds (cm-1).
        wl_thinning: keep every n-th wavenumber sample.
        isotope_ratios: text block of '<file_label> <label> <value>'
            lines declaring per-isotope tables (file_label is matched
            against the cs file names); value is a log10 abundance
            ratio (a retrievable parameter) or 'fill_<l1>_<l2>...'
            (ratio = 1 - sum of the named isotopes).  Reference:
            opacity/line_sampling.py:144-238.
        """
        if isinstance(cs_files, str):
            cs_files = [cs_files]
        self.cs_files = list(cs_files)

        iso_keys, iso_labels, iso_vals = [], [], []
        if isotope_ratios:
            for line in str(isotope_ratios).splitlines():
                if not line.strip():
                    continue
                fields = line.split()
                if len(fields) != 3:
                    raise ValueError(
                        'Invalid isotope_ratios entry (expected '
                        f"'<file_label> <label> <value>'): {line!r}"
                    )
                iso_keys.append(fields[0])
                iso_labels.append('iso_' + fields[1])
                iso_vals.append(fields[2])

        species0, temp, press, wn = pio.read_opacity(
            self.cs_files[0], extract='arrays',
        )
        self.temp = np.asarray(temp if temperature is None else temperature)
        self.ntemp = len(self.temp)
        self.press = np.asarray(press if pressure is None else pressure)
        self.nlayers = len(self.press)

        mask = wn_mask_tol(wn, min_wn, max_wn)
        self.wn = wn[mask][::wl_thinning]
        self.nwave = len(self.wn)

        species = []
        isotopes = []
        tags = []
        tables = []
        for cs_file in self.cs_files:
            spec, _, file_press, file_wn = pio.read_opacity(
                cs_file, extract='arrays',
            )
            iso = ''
            for key, label in zip(iso_keys, iso_labels):
                if key in cs_file:
                    if iso:
                        raise ValueError(
                            f'Multiple isotope labels match {cs_file!r}'
                        )
                    iso = label
            fmask = wn_mask_tol(file_wn, min_wn, max_wn)
            fwn = file_wn[fmask][::wl_thinning]
            if len(fwn) != self.nwave or np.any(
                    np.abs(1.0 - fwn / self.wn) > 0.01):
                raise ValueError(
                    f"Wavenumber array of '{cs_file}' does not match"
                )
            pmax, pmax_tab = np.amax(self.press), np.amax(file_press)
            if pmax / pmax_tab - 1 > 1e-3:
                raise ValueError(
                    'Pressure profile extends beyond the maximum tabulated '
                    'pressure'
                )
            table = interpolate_opacity(
                cs_file, self.temp, self.press, fmask, wl_thinning,
            )
            tag = spec + iso
            if tag in tags:
                tables[tags.index(tag)] += table
            else:
                tags.append(tag)
                species.append(spec)
                isotopes.append(iso)
                tables.append(table)
        self.species = np.array(species)
        self.isotopes = list(isotopes)
        self.nspec = len(self.species)
        # [nspec, ntemp, nlayers, nwave]:
        self.cs_table = np.stack(tables, axis=0)

        self.tmin = float(np.amin(self.temp))
        self.tmax = float(np.amax(self.temp))

        # Isotope abundance ratios: free parameters (log10) and fill
        # slots (1 - sum of the named isotopes):
        self.iso_ratios = np.ones(self.nspec)
        self.iso_fill = [None] * self.nspec
        self._iso_free = []
        self.pnames = []
        pars = []
        for i, iso in enumerate(self.isotopes):
            if iso == '':
                continue
            idx = iso_labels.index(iso)
            val = iso_vals[idx]
            if val.startswith('fill_'):
                fillers = ['iso_' + f for f in val[5:].split('_')]
                for filler in fillers:
                    if filler not in self.isotopes:
                        raise ValueError(
                            f'Invalid isotope_ratios filler {filler!r}: '
                            'no matching isotope table'
                        )
                self.iso_fill[i] = [
                    self.isotopes.index(f) for f in fillers
                ]
            else:
                self.iso_ratios[i] = 10.0 ** float(val)
                self.pnames.append(iso)
                self._iso_free.append(i)
                pars.append(float(val))
        self._update_iso_ratios()
        self.pars = list(pars)
        self.npars = len(pars)
        self.texnames = list(self.pnames)
        self.mol = list(self.species)

    def _update_iso_ratios(self, pars=None):
        """Host-side ratio update (reference
        line_sampling.py:282-298)."""
        if pars is not None:
            self.iso_ratios[self._iso_free] = 10.0 ** np.asarray(pars)
        for i, fillers in enumerate(self.iso_fill):
            if fillers is not None:
                self.iso_ratios[i] = 1.0 - np.sum(
                    self.iso_ratios[fillers],
                )

    def _jit_ratios(self, pars=None):
        """Jit-safe isotope ratios for the retrieval forward."""
        ratios = jnp.asarray(self.iso_ratios)
        if pars is not None and self._iso_free:
            ratios = ratios.at[jnp.asarray(self._iso_free)].set(
                10.0 ** jnp.asarray(pars),
            )
        for i, fillers in enumerate(self.iso_fill):
            if fillers is not None:
                ratios = ratios.at[i].set(
                    1.0 - jnp.sum(ratios[jnp.asarray(fillers)]),
                )
        return ratios

    def _t_weights(self, temperature):
        """Lower index + lerp weights along the temperature axis."""
        temp_grid = jnp.asarray(self.temp)
        temperature = jnp.asarray(temperature)
        tlo = jnp.clip(
            jnp.searchsorted(temp_grid, temperature, side='right') - 1,
            0, self.ntemp - 2,
        )
        dt = temp_grid[tlo + 1] - temp_grid[tlo]
        w_hi = (temperature - temp_grid[tlo]) / dt
        return tlo, w_hi

    def cross_section(self, temperature, per_mol=False):
        """CS (cm2 molec-1): T [nlayers] -> [(nspec,) nlayers, nwave].

        The T-lerp is expressed as a dense contraction over the (small)
        temperature axis instead of per-layer gathers: under vmap over
        retrieval chains the gather formulation re-reads two [l, w]
        table slices per chain (~0.7 GB/batch of gather traffic at the
        flagship shape), while the einsum reads the table once.
        """
        tlo, w_hi = self._t_weights(temperature)
        table = jnp.asarray(self.cs_table)          # [s, t, l, w]
        t_idx = jnp.arange(self.ntemp)[:, None]     # [t, 1]
        # Two-nonzero lerp weights per layer, [t, l]:
        w_t = (
            (t_idx == tlo[None, :]) * (1.0 - w_hi)[None, :]
            + (t_idx == tlo[None, :] + 1) * w_hi[None, :]
        )
        cs = jnp.einsum('tl,stlw->slw', w_t, table,
                        precision=jax.lax.Precision.HIGHEST)
        if per_mol:
            return cs
        return jnp.sum(cs, axis=0)

    def extinction(self, temperature, density, per_mol=False, pars=None):
        """EC (cm-1): density [nlayers, nspec] -> [(nspec,) nlayers, nwave].

        Equivalent of the reference interp_ec: lerp in T, times density
        (weighted by the isotope abundance ratios), summed over species.
        pars: free isotope-ratio parameters (log10), jit-safe.
        """
        if per_mol:
            cs = self.cross_section(temperature, per_mol=True)  # [s, l, w]
            weights = self._jit_ratios(pars)
            return cs * (
                jnp.asarray(density).T * weights[:, None]
            )[:, :, None]
        # Hot path (summed): fold the density/ratio weights into the
        # T-lerp contraction so the species sum, the lerp, and the
        # density product come out of ONE einsum -- no [s, l, w]
        # intermediates (the forward model is HBM-bandwidth-bound):
        tlo, w_hi = self._t_weights(temperature)
        table = jnp.asarray(self.cs_table)          # [s, t, l, w]
        t_idx = jnp.arange(self.ntemp)[:, None]     # [t, 1]
        w_t = (
            (t_idx == tlo[None, :]) * (1.0 - w_hi)[None, :]
            + (t_idx == tlo[None, :] + 1) * w_hi[None, :]
        )                                           # [t, l]
        weights = self._jit_ratios(pars)            # [s]
        d_w = jnp.asarray(density).T * weights[:, None]   # [s, l]
        w_stl = w_t[None, :, :] * d_w[:, None, :]   # [s, t, l] (tiny)
        return jnp.einsum('stl,stlw->lw', w_stl, table,
                          precision=jax.lax.Precision.HIGHEST)

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Line-sampled cross-section opacity:')
        fw.write('Number of species (nspec): {:d}', self.nspec)
        for spec, iso in zip(self.species, self.isotopes):
            fw.write('  {}{}', spec, f' ({iso})' if iso else '')
        fw.write(
            'Temperature range: {:.1f} -- {:.1f} K ({:d} samples)',
            self.tmin, self.tmax, self.ntemp,
        )
        fw.write(
            'Wavenumber range: {:.3f} -- {:.3f} cm-1 ({:d} samples)',
            float(self.wn[0]), float(self.wn[-1]), self.nwave,
        )
        fw.write('Pressure layers (nlayers): {:d}', self.nlayers)
        if self.npars:
            fw.write('Isotope-ratio parameters: {}', self.pnames)
        return fw.text
