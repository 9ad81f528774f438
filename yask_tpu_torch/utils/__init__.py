"""Common substrate shared by the compiler and the kernel runtime (copies
of ``yask_tpu.utils``: exceptions, index tuples, the CLI parser, FD
coefficients and timers)."""

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.utils.idx_tuple import IdxTuple
from yask_tpu_torch.utils.cli import CommandLineParser

__all__ = [
    "YaskException",
    "IdxTuple",
    "CommandLineParser",
]
