"""Test configuration: force an 8-device virtual CPU mesh.

Mirrors the reference's test approach of exercising MPI paths with real
`mpirun -np R` on one host (SURVEY §4 / ``src/kernel/Makefile:977``): here
the multi-device paths run on XLA's host-platform device emulation, so every
sharding/collective path executes for real without TPU hardware.

Must run before jax is first imported anywhere in the test session.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# Keep compile times sane for the many tiny programs tests build.
os.environ.setdefault("JAX_ENABLE_X64", "0")


def pytest_configure(config):
    # tier-1 runs with -m 'not slow'; register the marker so the
    # perfcheck/bench integration tests can opt out without warnings
    config.addinivalue_line(
        "markers", "slow: timed perf/integration test excluded from the "
        "tier-1 `-m 'not slow'` run")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (the port's kernels "
        "on the card); skips with a reason where there is none")
