"""Multi-host bootstrap: jax.distributed initialization.

The reference's multi-process story is mpi4py rank/size discovery plus
MPI shared-memory windows (tools/mpi_tools.py:18-116,
opacity/line_sampling.py:253-275).  The equivalent here is one
jax.distributed process group per host: after initialization,
jax.devices() spans every device of every process, and the same
(chains, wave) mesh + GSPMD program runs unchanged -- XLA inserts the
collectives.

Configuration, in precedence order:
  1. config keys  dist_coordinator / dist_nprocs / dist_procid;
  2. environment  PBT_COORDINATOR / PBT_NPROCS / PBT_PROCID;
  3. PBT_NPROCS=auto: JAX's own cluster detection,
     jax.distributed.initialize() with no arguments, for the cluster
     environments JAX recognizes.
"""
import os

__all__ = [
    'initialize_distributed', 'is_initialized', 'process_index',
    'process_count',
]

_initialized = False


def initialize_distributed(cfg=None):
    """Initialize the jax.distributed process group if configured.

    Returns True when running multi-process after the call, False for
    single-process runs.  Safe to call multiple times.
    """
    global _initialized
    import jax

    if _initialized:
        return jax.process_count() > 1

    coordinator = nprocs = procid = None
    if cfg is not None:
        coordinator = getattr(cfg, 'dist_coordinator', None)
        nprocs = getattr(cfg, 'dist_nprocs', None)
        procid = getattr(cfg, 'dist_procid', None)
    if coordinator is None:
        coordinator = os.environ.get('PBT_COORDINATOR')
    if nprocs is None:
        nprocs = os.environ.get('PBT_NPROCS') or None
    if procid is None and os.environ.get('PBT_PROCID'):
        procid = int(os.environ['PBT_PROCID'])

    if coordinator is None and nprocs is None:
        return False
    if str(nprocs) == 'auto':
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=int(nprocs) if nprocs is not None else None,
            process_id=procid,
        )
    _initialized = True
    return jax.process_count() > 1


def is_initialized():
    return _initialized


def process_index():
    """This process's rank (0 for single-process runs)."""
    import jax
    return jax.process_index() if _initialized else 0


def process_count():
    import jax
    return jax.process_count() if _initialized else 1
