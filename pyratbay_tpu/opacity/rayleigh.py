"""Rayleigh-scattering cross sections.

Closed-form polynomial models from Dalgarno (1962), Kurucz (1970), and
Dalgarno & Williams (1962) for H, H2, He, and free electrons (Thomson).
Reference behavior: pyratbay/opacity/rayleigh/rayleigh.py.
"""
import numpy as np
import jax.numpy as jnp

__all__ = ['Rayleigh']

_COEFS = {
    'H': (5.799e-45, 1.422e-54, 2.784e-64),
    'H2': (8.140e-45, 1.280e-54, 1.610e-64),
}
_HE_COEFS = (5.484e-46, 2.440e-11, 5.940e-42, 2.900e-11)
_THOMSON_CS = 6.653e-25  # cm2


class Rayleigh:
    """Zero-parameter Rayleigh model for one species.

    The cross section is a fixed spectrum (precomputed, static); the
    extinction coefficient is cs * density.
    """

    def __init__(self, species, wn):
        if species not in ('H', 'H2', 'He', 'e-'):
            raise ValueError(f"Invalid Rayleigh species '{species}'")
        self.name = f'rayleigh_{species}'
        self.species = species
        self.wn = np.asarray(wn)
        self.npars = 0
        self.pnames = []
        self.texnames = []
        self.pars = []
        self.cross_section = self._calc_cross_section()

    def _calc_cross_section(self):
        wn = self.wn
        if self.species in _COEFS:
            c0, c1, c2 = _COEFS[self.species]
            cs = c0 * wn**4 + c1 * wn**6 + c2 * wn**8
        elif self.species == 'He':
            c0, c1, c2, c3 = _HE_COEFS
            cs = c0 * wn**4 * (
                1.0 + c1 * wn**2 + c2 * wn**4 / (1.0 - c3 * wn**2)
            ) ** 2
        else:  # e- (Thomson scattering)
            cs = np.full(len(wn), _THOMSON_CS)
        return cs

    def extinction(self, density):
        """EC (cm-1): density [nlayers] of this species -> [nlayers, nwave]."""
        return jnp.asarray(self.cross_section)[None, :] * density[:, None]

    def ec_rank1(self, density):
        """Rank-1 factorization (layer column, wave row) of the EC:
        the ensemble RT kernel composes col x row in registers, so the
        dense [B, nlayers, nwave] buffer never reaches device memory."""
        return density, jnp.asarray(self.cross_section)

    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Rayleigh opacity model: {}', self.name)
        fw.write('Species: {}', self.species)
        fw.write(
            'Cross section range: {:.3e} -- {:.3e} cm2 molec-1',
            float(np.min(self.cross_section)),
            float(np.max(self.cross_section)),
        )
        return fw.text
