"""Kernel runtime of the port: the ``yk_*`` API on PyTorch tensors and
the fused CUDA kernel, one device."""

from yask_tpu_torch.runtime.env import yk_env
from yask_tpu_torch.runtime.settings import KernelSettings
from yask_tpu_torch.runtime.factory import yk_factory
from yask_tpu_torch.runtime.context import StencilContext

__all__ = ["yk_env", "KernelSettings", "yk_factory", "StencilContext"]
