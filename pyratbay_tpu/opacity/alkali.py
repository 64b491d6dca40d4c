"""Alkali (Na, K) resonance-line opacity.

Van der Waals + statistical-theory model of Burrows et al. (2000),
ApJ 531, 438: a Lorentz core inside the detuning region and
(dnu/dsigma)^-1.5 power-law wings anchored at the Voigt value at the
detuning frequency, with an exponential Boltzmann cutoff.
Reference behavior: pyratbay/opacity/alkali/alkali.py and src_c/_alkali.c.

The whole model is a dense (layer, line, wave) broadcast -- no loops,
no scatter; XLA fuses it into a single elementwise kernel.
"""
import numpy as np
import jax.numpy as jnp

from .. import constants as pc
from ..ops.special import voigt_ref

__all__ = ['SodiumVdW', 'PotassiumVdW', 'get_alkali_model']


class VanderWaals:
    """Base alkali model; subclasses define the line data."""

    species = None
    # line data set by subclasses:
    wn0 = None
    gf = None
    elow = None
    lpar = None
    part_func = None
    detuning = None

    def __init__(self, pressure, wn, cutoff=4500.0, mass=None):
        """
        Parameters
        ----------
        pressure: 1D array, bar.
        wn: 1D array, cm-1 (monotonic; model output follows this grid).
        cutoff: float, hard profile cutoff from line center (cm-1).
        """
        self.pressure = np.asarray(pressure)
        self.wn = np.asarray(wn)
        self.nwave = len(self.wn)
        self.nlayers = len(self.pressure)
        self.cutoff = cutoff
        self.nlines = len(self.wn0)
        self.npars = 0
        self.pnames = []
        self.texnames = []
        self.pars = []
        if mass is None:
            from ..io.io import species_properties
            masses, _ = species_properties([self.species])
            mass = masses[0]
        self.mass = mass
        self.mol = self.species
        # Static line pruning: a line whose entire cutoff window lies
        # off the wavenumber grid contributes EXACTLY zero (the
        # |dnu| <= cutoff mask would reject every point), yet its
        # dense (layer, wave) profile -- two transcendentals per
        # element -- was still computed.  The flagship 1.1-1.7 um grid
        # with Na D at 0.589 um is the extreme case: the whole model
        # was masked zeros:
        self.active_lines = [
            i for i in range(self.nlines)
            if (self.wn0[i] - cutoff <= self.wn[-1]
                and self.wn0[i] + cutoff >= self.wn[0])
        ]

    def cross_section(self, temperature):
        """Cross section (cm2 molec-1): T [nlayers] -> [nlayers, nwave].

        Pure JAX function; follows the reference C kernel exactly
        (src_c/_alkali.c:56-101).
        """
        temp = jnp.asarray(temperature)[:, None]              # [lay, 1]
        press = jnp.asarray(self.pressure)[:, None] * pc.bar  # barye
        wn0 = jnp.asarray(self.wn0)[None, :]                  # [1, line]
        gf = jnp.asarray(self.gf)[None, :]

        # Per (layer, line) widths:
        doppler = (
            jnp.sqrt(2.0 * pc.k * temp / (self.mass * pc.amu)) * wn0 / pc.c
        )
        lorentz = self.lpar * (temp / 2000.0) ** -0.7 * press / pc.atm
        dsigma = self.detuning * (temp / 500.0) ** 0.6        # [lay, 1]

        # Voigt value at the detuning boundary (wing anchor):
        voigt_det = voigt_ref(dsigma, lorentz, doppler)       # [lay, line]

        # Per-line spectra, summed in an unrolled Python loop (nlines
        # is 2): keeping the line axis out of the arrays makes the
        # whole cross section one ELEMENTWISE fusion chain -- XLA
        # reduce fusions pick batch-minor layouts under an ensemble
        # and force full-size layout copies in front of the fused RT
        # kernel; elementwise fusions are layout-flexible.
        wave = jnp.asarray(self.wn)[None, :]
        dsig = dsigma                                       # [lay, 1]
        total = None
        if not self.active_lines:
            return jnp.zeros(
                (self.nlayers, self.nwave), dtype=temp.dtype,
            )
        for i in self.active_lines:
            dwn = wave - wn0[0, i]                          # [lay?, wave]
            abs_dwn = jnp.abs(dwn)
            strength = pc.C3_KERNEL * float(self.gf[i]) / self.part_func

            # (dnu/dsigma)^-1.5 via sqrt instead of pow: pow lowers to
            # exp(log()) on the device and this block is the forward
            # model's transcendental hot spot; t*sqrt(t) with
            # t = dsigma/dnu is exact for the 3/2 exponent:
            t_ratio = dsig / abs_dwn
            wing = (
                voigt_det[:, i:i + 1]
                * (t_ratio * jnp.sqrt(t_ratio))
                * strength
                * jnp.exp(-pc.C2_KERNEL * (abs_dwn - dsig) / temp)
            )
            core = lorentz / np.pi / (lorentz**2 + dwn**2) * strength
            # (The Boltzmann exp(-Elow/T)(1-exp(-wn0/T)) factor is ~1
            # below 4000 K and is omitted, as in the reference.)
            profile = jnp.where(abs_dwn >= dsig, wing, core)
            profile = jnp.where(abs_dwn <= self.cutoff, profile, 0.0)
            total = profile if total is None else total + profile
        return total

    def extinction(self, temperature, density):
        """EC (cm-1): density [nlayers] of this species."""
        return self.cross_section(temperature) * density[:, None]


    def __str__(self):
        from ..tools import Formatted_Write
        fw = Formatted_Write()
        fw.write('Alkali van der Waals opacity: {}', self.name)
        fw.write('Species: {}', self.species)
        fw.write('Line centers (cm-1): {}', [float(w) for w in np.round(self.wn0, 3)])
        fw.write('Detuning cutoff (cutoff): {}', self.cutoff)
        return fw.text


class SodiumVdW(VanderWaals):
    """Na D doublet (VALD line data; Burrows et al. 2000)."""

    species = 'Na'
    wn0 = [16960.87, 16978.07]
    elow = [0.0, 0.0]
    gf = [0.65464, 1.30918]
    lpar = 0.071        # Lorentz-width parameter (Iro et al. 2005)
    part_func = 2.0     # Partition function, T < 4000 K (Barklem 2016)
    detuning = 30.0     # Detuning parameter (cm-1 scale)

    def __init__(self, pressure, wn, cutoff=4500.0, mass=None):
        self.name = 'sodium_vdw'
        super().__init__(pressure, wn, cutoff, mass)


class PotassiumVdW(VanderWaals):
    """K resonance doublet (VALD line data; Burrows et al. 2000)."""

    species = 'K'
    wn0 = [12988.76, 13046.486]
    elow = [0.0, 0.0]
    gf = [0.701455, 1.40929]
    lpar = 0.14
    part_func = 2.0
    detuning = 20.0

    def __init__(self, pressure, wn, cutoff=4500.0, mass=None):
        self.name = 'potassium_vdw'
        super().__init__(pressure, wn, cutoff, mass)


def get_alkali_model(name, *args, **kwargs):
    if name == 'sodium_vdw':
        return SodiumVdW(*args, **kwargs)
    if name == 'potassium_vdw':
        return PotassiumVdW(*args, **kwargs)
    raise ValueError(
        f"Invalid alkali model '{name}', select from {pc.ALKALI_MODELS}"
    )
