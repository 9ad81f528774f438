"""Device-mesh construction and state split specs.

The port's counterpart of ``yask_tpu/parallel/mesh.py``.  The reference
arranges MPI ranks in an N-D grid and records per-rank offsets
(``setup_rank``, ``setup.cpp:169``); ``yask_tpu`` makes the grid a
``jax.sharding.Mesh`` whose axis names are the solution's domain dims.
Here the mesh is a small :class:`Mesh`: a numpy object array of
``torch.device`` shaped by the rank grid, with the dims as axis names.
One controller process drives every shard, so a shard is a position in
the array: its tensors live on the device there, and the same device may
appear at several positions (``["cuda:0"] * 4``), each with tensors of
its own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from yask_tpu_torch.utils.exceptions import YaskException


class Mesh:
    """The device grid of the shard modes (see the module docstring).

    ``devices`` — numpy object array of ``torch.device``, one axis per
    name in ``axis_names``; ``shape`` — ``{axis: extent}``.  Shards are
    numbered in C order over the array (:meth:`coords`, :meth:`index`)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, i: int) -> Dict[str, int]:
        """Mesh position ``{axis: index}`` of shard ``i``."""
        pos = np.unravel_index(i, self.devices.shape)
        return {a: int(p) for a, p in zip(self.axis_names, pos)}

    def index(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names), self.devices.shape))

    def device(self, i: int):
        return self.devices.flat[i]

    def neighbour_pairs(self, axis: str) -> List[Tuple[int, int]]:
        """``(left, right)`` shard pairs that touch across ``axis``: the
        right one sits one step further along the axis."""
        pairs = []
        for i in range(self.size):
            c = self.coords(i)
            if c[axis] + 1 < self.shape[axis]:
                c[axis] += 1
                pairs.append((i, self.index(c)))
        return pairs

    def edges(self, axis: str, left: bool) -> List[int]:
        """Shards with no neighbour on the given side of ``axis``."""
        end = 0 if left else self.shape[axis] - 1
        return [i for i in range(self.size) if self.coords(i)[axis] == end]

    def num_cards(self) -> int:
        """Distinct devices in the grid."""
        return len(set(self.devices.flat))

    def __repr__(self):
        devs = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, {devs})"


def make_mesh(devices, axis_sizes):
    """THE mesh factory, the one construction site of :class:`Mesh`.

    ``devices`` is a flat device list (repeats allowed); ``axis_sizes`` an
    ordered ``(name, extent)`` sequence.  The first ``prod(extents)``
    devices fill the grid in C order."""
    axis_sizes = list(axis_sizes)
    dims = [d for d, _n in axis_sizes]
    shape = [int(n) for _d, n in axis_sizes]
    need = int(np.prod(shape))
    devices = list(devices)
    if need > len(devices):
        raise YaskException(
            f"mesh {dict(zip(dims, shape))} needs {need} devices, "
            f"have {len(devices)}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names=tuple(dims))  # lint: mesh-ok


def build_mesh(env, opts) -> Mesh:
    """Mesh over the device grid implied by ``opts.num_ranks``."""
    nr = opts.num_ranks
    dims = nr.get_dim_names()
    return make_mesh(env.get_devices(), [(d, nr[d]) for d in dims])


def state_shardings(mesh: Mesh, program, opts) -> Dict[str, tuple]:
    """Per var, its split spec: one entry per array axis, the dim name
    where that domain axis is split over the mesh (extent > 1), else None
    (the counterpart of the reference's ``PartitionSpec``s)."""
    out = {}
    for name, g in program.geoms.items():
        if g.is_scratch:
            continue
        out[name] = tuple(
            n if kind == "domain" and opts.num_ranks.get(n, 1) > 1
            else None for n, kind in g.axes)
    return out
