"""pyratbay_tpu: accelerator-native radiative transfer and Bayesian retrieval
for exoplanet atmospheres.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
Pyrat Bay reference package: line lists -> opacities -> 1D atmospheric
models -> transmission/emission/eclipse spectra -> MCMC retrieval --
redesigned around functional transforms, fused dense kernels, and SPMD
sharding over device meshes.
"""
from .version import __version__

from . import constants
from . import ops
from . import atmosphere
from . import opacity
from . import spectrum
from . import io
from . import tools
from .driver import run
from .model import Model

__all__ = [
    '__version__',
    'constants', 'ops', 'atmosphere', 'opacity', 'spectrum', 'io',
    'tools', 'run', 'Model',
]
