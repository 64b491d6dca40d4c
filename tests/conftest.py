"""Test configuration.

Accuracy parity with the reference's float64 golden files requires x64;
tests run on CPU with a virtual 8-device mesh so multi-device sharding
paths are exercised without accelerators.  (chip_smoke.py and bench.py
run separately on the GPU in float32.)
"""
import os

# CPU unless the caller names a platform (the GPU tests run with
# JAX_PLATFORMS=cuda,cpu):
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8'
    ).strip()

import jax

jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
jax.config.update('jax_enable_x64', True)

import pytest  # noqa: E402

# Reference installation (read-only), used for golden-file cross checks:
REFERENCE_ROOT = '/root/reference/'


def reference_available():
    return os.path.isdir(REFERENCE_ROOT)


requires_reference = pytest.mark.skipif(
    not reference_available(),
    reason='reference golden files not available',
)


@pytest.fixture
def ref_root():
    return REFERENCE_ROOT


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips the test otherwise."""
    device = jax.devices()[0]
    if device.platform != 'gpu':
        pytest.skip(f'needs a GPU (JAX found {device.platform})')
    return device
