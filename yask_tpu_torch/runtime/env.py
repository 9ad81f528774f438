"""Kernel environment: the devices a solution runs on.

Counterpart of ``yask_tpu/runtime/env.py`` (reference ``yk_env``,
``include/yask_kernel_api.hpp:167-293``).  Like the reference, one
controller process drives a list of devices, the "ranks" a solution's
domain is decomposed over by the shard modes: every visible CUDA device
by default (``jax.devices()`` lists them all), or the ``devices=`` the
caller gives.  A device may repeat: ``["cuda:0"] * 4`` puts four shards,
each with its own tensors, on one card, as the reference's tests put
eight on XLA's virtual CPU devices.  The single-device modes run on
``devices[0]``.  The CPU is used only on request (``device="cpu"`` or
``devices=["cpu"] * n``); on a host with no CUDA device and no such
request the env raises instead of carrying on silently on the CPU.
Multi-process bootstrap and profiler hooks (``jax.distributed``/
``jax.profiler`` in the reference package) are not carried (ROADMAP.md
A11, A14).
"""

from __future__ import annotations

import sys
from typing import List

from yask_tpu_torch.utils.exceptions import YaskException

#: Device-memory peak of the cards the port knows, bytes/s (NVIDIA data
#: sheets, SXM parts) — the roofline denominator in ``yk_stats``.
_HBM_PEAK = (("H200", 4.8e12), ("H100", 3.35e12))


class yk_env:
    """Execution environment: the device list, debug output, trace
    gating."""

    def __init__(self, device=None, devices=None):
        import torch
        if device is not None and devices is not None:
            raise YaskException("give new_env device= or devices=, not both")
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise YaskException("devices= is an empty list")
        elif device is not None:
            devices = [torch.device(device)]
        else:
            if not torch.cuda.is_available():
                raise YaskException(
                    "no CUDA device on this host; pass device=\"cpu\" to "
                    "new_env (or -device cpu on the command line) to run "
                    "on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        for d in devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise YaskException(
                    f"device '{d}' requested but no CUDA device is "
                    "available; pass device=\"cpu\" to run on the CPU")
        self._devices = devices
        self._device = devices[0]
        self._trace = False
        self._debug = sys.stdout

    # ---- device/"rank" info ---------------------------------------------

    def get_device(self):
        """The ``torch.device`` the single-device modes run on (the first
        of the list)."""
        return self._device

    def get_num_ranks(self) -> int:
        """Number of devices available for domain decomposition (the
        reference's MPI world size), repeats included."""
        return len(self._devices)

    def get_rank_index(self) -> int:
        """Always 0: one controller process drives every device."""
        return 0

    def get_devices(self) -> List:
        return list(self._devices)

    def get_num_cards(self) -> int:
        """Distinct devices in the list (the roofline denominator of the
        shard modes counts cards, not shards)."""
        return len(set(self._devices))

    def get_platform(self) -> str:
        """"gpu" for a CUDA device, "cpu" otherwise."""
        return "gpu" if self._device.type == "cuda" else "cpu"

    def get_device_name(self) -> str:
        if self._device.type != "cuda":
            return "cpu"
        import torch
        return torch.cuda.get_device_name(self._device)

    def get_hbm_peak_bytes_per_sec(self) -> float:
        """Device-memory peak of the card (0.0 when unknown, e.g. the CPU,
        where a roofline fraction is meaningless)."""
        name = self.get_device_name()
        for tag, peak in _HBM_PEAK:
            if tag in name:
                return peak
        return 0.0

    # ---- collectives-over-ranks (one controller: trivial, kept for parity)

    def global_barrier(self) -> None:
        import torch
        for d in set(self._devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def sum_over_ranks(self, val: int) -> int:
        return val

    def min_over_ranks(self, val: int) -> int:
        return val

    def max_over_ranks(self, val: int) -> int:
        return val

    def assert_equality_over_ranks(self, val: int, descr: str = "") -> None:
        return None

    # ---- debug & trace ---------------------------------------------------

    def set_trace_enabled(self, enable: bool) -> None:
        self._trace = bool(enable)

    def is_trace_enabled(self) -> bool:
        return self._trace

    def set_debug_output(self, out) -> None:
        self._debug = out.get_ostream() if hasattr(out, "get_ostream") else out

    def get_debug_output(self):
        return self._debug

    def trace_msg(self, msg: str) -> None:
        if self._trace:
            self._debug.write(f"YASK-TORCH: {msg}\n")

    def finalize(self) -> None:
        """Counterpart of MPI_Finalize; nothing to tear down."""
