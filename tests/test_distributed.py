"""Multi-process jax.distributed tests (CPU process group).

The reference's multi-process path is mpi4py rank/size discovery plus
shared-memory windows (tools/mpi_tools.py:66-116,
opacity/line_sampling.py:253-275); its own MPI tests are skipped in CI.
Here the repo's bootstrap (parallel/distributed.py) is actually
executed: a 2-process jax.distributed group (2 virtual CPU devices per
process = 4 global devices) runs the wave-sharded flagship retrieval
and must reproduce the single-process run of the identical global
program bit-for-bit-close.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'dist_worker.py')


def _free_port():
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _run_group(nprocs, local_devices, out_path, timeout=900):
    """Launch an nprocs-process jax.distributed group; wait for all."""
    env_base = dict(os.environ)
    env_base.pop('JAX_PLATFORMS', None)
    env_base.pop('XLA_FLAGS', None)
    env_base['PYTHONPATH'] = (
        REPO + os.pathsep + env_base.get('PYTHONPATH', '')
    )
    env_base['PBT_LOCAL_DEVICES'] = str(local_devices)
    env_base['PBT_OUT'] = out_path
    if nprocs > 1:
        env_base['PBT_COORDINATOR'] = f'localhost:{_free_port()}'
        env_base['PBT_NPROCS'] = str(nprocs)

    procs = []
    for rank in range(nprocs):
        env = dict(env_base)
        if nprocs > 1:
            env['PBT_PROCID'] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outputs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        outputs.append(out)
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, (
            f'rank {rank} failed (rc={proc.returncode}):\n{out[-4000:]}'
        )
    return outputs


def test_multiprocess_flagship_matches_single_process(tmp_path):
    """2 processes x 2 devices == 1 process x 4 devices: the sharded
    flagship log-posterior and two DEMC generations agree."""
    out_multi = str(tmp_path / 'multi.npz')
    out_single = str(tmp_path / 'single.npz')

    _run_group(2, 2, out_multi)
    _run_group(1, 4, out_single)

    multi = np.load(out_multi)
    single = np.load(out_single)
    assert int(multi['nprocs']) == 2
    assert int(multi['ndevices']) == 4
    assert int(single['nprocs']) == 1
    assert int(single['ndevices']) == 4

    np.testing.assert_allclose(
        multi['logp0'], single['logp0'], rtol=1e-8,
    )
    np.testing.assert_allclose(
        multi['chains'], single['chains'], rtol=1e-8, atol=1e-12,
    )
    np.testing.assert_allclose(
        multi['logp'], single['logp'], rtol=1e-8,
    )


@pytest.mark.parametrize('env, expected', [
    ({'PBT_NPROCS': 'auto'}, {}),
    ({'PBT_COORDINATOR': 'localhost:1234', 'PBT_NPROCS': '2',
      'PBT_PROCID': '1'},
     {'coordinator_address': 'localhost:1234', 'num_processes': 2,
      'process_id': 1}),
])
def test_initialize_distributed_env(monkeypatch, env, expected):
    """PBT_NPROCS=auto hands cluster detection to JAX; numeric
    settings are passed through as integers."""
    import jax
    from pyratbay_tpu.parallel import distributed
    calls = []
    monkeypatch.setattr(jax.distributed, 'initialize',
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed, '_initialized', False)
    for key in ('PBT_COORDINATOR', 'PBT_NPROCS', 'PBT_PROCID'):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    distributed.initialize_distributed()
    assert calls == [expected]
