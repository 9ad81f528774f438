"""Runtime vars: the ``yk_var`` API over ring-buffered padded tensors.

Counterpart of ``yask_tpu/runtime/var.py`` (the reference's var storage
layer, ``src/kernel/lib/yk_var.hpp``, ``yk_var_apis.cpp``): element and
slice access with numpy interop, halo/pad/alloc geometry per dim,
step-index wrapping, reductions, and fixed-size vars.

Storage is a list of padded arrays (the step ring) owned by the
:class:`~yask_tpu_torch.runtime.context.StencilContext`: tensors on the
context's ``torch.device``, or numpy arrays while the numpy oracle holds
the state.  A ``yk_var`` is a view binding the var name to that state.
Pads stay zero: every write goes through the context, which writes
interiors only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from yask_tpu_torch.utils.exceptions import YaskException


class yk_var:
    """View of one var's storage + geometry."""

    def __init__(self, ctx, name: str):
        self._ctx = ctx
        self._name = name

    # -- identity & geometry ----------------------------------------------

    def _geom(self):
        g = self._ctx._program.geoms.get(self._name) if self._ctx._program \
            else None
        if g is None:
            if getattr(self._ctx, "_ended", False):
                raise YaskException(
                    f"var '{self._name}': end_solution was called; call "
                    "prepare_solution again to access var data")
            raise YaskException(
                f"var '{self._name}' not available before prepare_solution")
        return g

    def get_name(self) -> str:
        return self._name

    def get_num_dims(self) -> int:
        return len(self._var().get_dims())

    def get_dim_names(self) -> List[str]:
        return self._var().get_dim_names()

    def is_dim_used(self, dim: str) -> bool:
        return dim in self._var().get_dim_names()

    def _var(self):
        return self._ctx._soln.get_var(self._name)

    def is_fixed_size(self) -> bool:
        return False

    # halo / pad / alloc geometry per domain dim (yk_var_api.hpp geometry
    # accessors; values fixed at prepare time like the reference post-alloc)
    def get_left_halo_size(self, dim: str) -> int:
        return self._var().halo.get(dim, (0, 0))[0]

    def get_right_halo_size(self, dim: str) -> int:
        return self._var().halo.get(dim, (0, 0))[1]

    def get_halo_size(self, dim: str) -> int:
        l, r = self._var().halo.get(dim, (0, 0))
        return max(l, r)

    def set_halo_size(self, dim: str, size: int) -> None:
        """Grow the halo before prepare (``yk_var::set_halo_size``)."""
        if self._ctx._program is not None:
            raise YaskException("cannot change halo after prepare_solution")
        self._var().update_halo(dim, size)
        self._var().update_halo(dim, -size)

    def get_left_pad_size(self, dim: str) -> int:
        return self._geom().pads.get(dim, (0, 0))[0]

    def get_right_pad_size(self, dim: str) -> int:
        return self._geom().pads.get(dim, (0, 0))[1]

    def get_alloc_size(self, dim: str) -> int:
        g = self._geom()
        if dim in g.domain_dims:
            return g.shape[g.axis_of(dim)]
        for n, k in g.axes:
            if n == dim:
                return g.shape[g.axis_of(dim)]
        v = self._var()
        if v.step_dim() is not None and v.step_dim().name == dim:
            return g.alloc
        raise YaskException(f"var '{self._name}' has no dim '{dim}'")

    def get_first_misc_index(self, dim: str) -> int:
        return self._geom().misc_lo[dim]

    def get_last_misc_index(self, dim: str) -> int:
        g = self._geom()
        return g.misc_lo[dim] + g.misc_ext[dim] - 1

    def set_first_misc_index(self, dim: str, idx: int) -> None:
        """Re-base a misc dim's first index (``yk_var_api.hpp``; before
        prepare, like the reference's pre-alloc requirement)."""
        if self._ctx._program is not None:
            raise YaskException(
                "cannot re-base misc indices after prepare_solution")
        v = self._var()
        ext = v.misc_range[dim][1] - v.misc_range[dim][0]
        v.misc_range[dim] = (idx, idx + ext)

    # -- full accessor parity (yk_var_api.hpp) -------------------------
    # The reference distinguishes rank-domain / halo / alloc / "local"
    # index spaces per dim.  This runtime runs one device, so rank ==
    # overall and "local" == allocation (one address space):
    #   first_rank_domain_index = 0, last = size−1;
    #   halo indices extend by the halos, alloc/local by the pads.

    def get_num_domain_dims(self) -> int:
        return len(self._var().domain_dim_names())

    def get_domain_dim_names(self) -> List[str]:
        return list(self._var().domain_dim_names())

    def get_misc_dim_names(self) -> List[str]:
        return [n for n, k in self._geom().axes if k == "misc"]

    def get_step_dim_name(self) -> str:
        sd = self._var().step_dim()
        return sd.name if sd is not None else ""

    def get_left_extra_pad_size(self, dim: str) -> int:
        return self.get_left_pad_size(dim) - self.get_left_halo_size(dim)

    def get_right_extra_pad_size(self, dim: str) -> int:
        return self.get_right_pad_size(dim) - self.get_right_halo_size(dim)

    def set_left_halo_size(self, dim: str, size: int) -> None:
        """Grow-only, like ``set_halo_size``: the analysis-computed read
        radius is the floor (shrinking below it would undersize pads)."""
        v = self._var()
        if self._ctx._program is not None:
            raise YaskException("cannot change halo after prepare_solution")
        l, r = v.halo.get(dim, (0, 0))
        v.halo[dim] = (max(l, size), r)

    def set_right_halo_size(self, dim: str, size: int) -> None:
        v = self._var()
        if self._ctx._program is not None:
            raise YaskException("cannot change halo after prepare_solution")
        l, r = v.halo.get(dim, (0, 0))
        v.halo[dim] = (l, max(r, size))

    def get_min_pad_size(self, dim: str) -> int:
        return self._ctx._opts.min_pad_sizes[dim]

    def set_min_pad_size(self, dim: str, size: int) -> None:
        """Request at least this much pad (``yk_var::set_min_pad_size``).
        Applied at the next prepare; recorded per dim (a per-var request
        widens every var — a superset of the reference's guarantee)."""
        o = self._ctx._opts
        o.min_pad_sizes[dim] = max(o.min_pad_sizes[dim], int(size))

    set_left_min_pad_size = set_min_pad_size
    set_right_min_pad_size = set_min_pad_size

    def get_rank_domain_size(self, dim: str) -> int:
        return self._ctx.get_overall_domain_size(dim)

    def get_first_rank_domain_index(self, dim: str) -> int:
        return 0

    def get_last_rank_domain_index(self, dim: str) -> int:
        return self._ctx.get_overall_domain_size(dim) - 1

    def get_first_rank_halo_index(self, dim: str) -> int:
        return -self.get_left_halo_size(dim)

    def get_last_rank_halo_index(self, dim: str) -> int:
        return self.get_last_rank_domain_index(dim) \
            + self.get_right_halo_size(dim)

    def get_first_rank_alloc_index(self, dim: str) -> int:
        return -self.get_left_pad_size(dim)

    def get_last_rank_alloc_index(self, dim: str) -> int:
        return self.get_last_rank_domain_index(dim) \
            + self.get_right_pad_size(dim)

    def get_first_local_index(self, dim: str) -> int:
        """First allocated index in ``dim`` (one address space: local ==
        alloc; step dim → oldest valid step, misc → first misc)."""
        g = self._geom()
        v = self._var()
        if v.step_dim() is not None and v.step_dim().name == dim:
            return self.get_first_valid_step_index()
        for n, k in g.axes:
            if n == dim and k == "misc":
                return self.get_first_misc_index(dim)
        return self.get_first_rank_alloc_index(dim)

    def get_last_local_index(self, dim: str) -> int:
        g = self._geom()
        v = self._var()
        if v.step_dim() is not None and v.step_dim().name == dim:
            return self.get_last_valid_step_index()
        for n, k in g.axes:
            if n == dim and k == "misc":
                return self.get_last_misc_index(dim)
        return self.get_last_rank_alloc_index(dim)

    def get_first_valid_step_index(self) -> int:
        """Smallest valid step index currently in the ring
        (``yk_var_api.hpp:317``).  Metadata-only: answered from the
        geometry.
        For reverse-time solutions (step_dir=-1) the oldest slot has the
        LARGER index, so first/last are ordered numerically (ADVICE r3)
        to keep ``are_indices_local`` range checks valid."""
        nslots = self._geom().num_slots
        d = self._ctx._csol.ana.step_dir or 1
        oldest = self._ctx._cur_step - (nslots - 1) * d
        return min(oldest, self._ctx._cur_step)

    def get_last_valid_step_index(self) -> int:
        nslots = self._geom().num_slots
        d = self._ctx._csol.ana.step_dir or 1
        oldest = self._ctx._cur_step - (nslots - 1) * d
        return max(oldest, self._ctx._cur_step)

    def are_indices_local(self, indices) -> bool:
        """True when every index is within the allocated (local) bounds
        (``yk_var_api.hpp:565``)."""
        names = self.get_dim_names()
        try:
            for n, i in zip(names, indices):
                if not (self.get_first_local_index(n) <= i
                        <= self.get_last_local_index(n)):
                    return False
        except YaskException:
            return False
        return True

    # vector forms (the reference's idx_t_vec overloads): values in
    # declared-dim order
    def _vec(self, fn, dims=None):
        return [fn(d) for d in (dims or self.get_dim_names())]

    def get_alloc_size_vec(self):
        return self._vec(self.get_alloc_size)

    def get_first_local_index_vec(self):
        return self._vec(self.get_first_local_index)

    def get_last_local_index_vec(self):
        return self._vec(self.get_last_local_index)

    def get_first_rank_domain_index_vec(self):
        return self._vec(self.get_first_rank_domain_index,
                         self.get_domain_dim_names())

    def get_last_rank_domain_index_vec(self):
        return self._vec(self.get_last_rank_domain_index,
                         self.get_domain_dim_names())

    def get_first_rank_halo_index_vec(self):
        return self._vec(self.get_first_rank_halo_index,
                         self.get_domain_dim_names())

    def get_last_rank_halo_index_vec(self):
        return self._vec(self.get_last_rank_halo_index,
                         self.get_domain_dim_names())

    def get_first_rank_alloc_index_vec(self):
        return self._vec(self.get_first_rank_alloc_index,
                         self.get_domain_dim_names())

    def get_last_rank_alloc_index_vec(self):
        return self._vec(self.get_last_rank_alloc_index,
                         self.get_domain_dim_names())

    def get_rank_domain_size_vec(self):
        return self._vec(self.get_rank_domain_size,
                         self.get_domain_dim_names())

    # parity toggles
    def is_dynamic_step_alloc(self) -> bool:
        return False   # ring allocations are static

    def get_numa_preferred(self) -> int:
        return self._ctx._opts.numa_pref

    def set_numa_preferred(self, node: int) -> bool:
        self._ctx._opts.numa_pref = int(node)   # accepted for parity
        return True

    def get_halo_exchange_l1_norm(self) -> int:
        return getattr(self, "_l1_norm", 0)

    def set_halo_exchange_l1_norm(self, norm: int) -> None:
        # accepted for parity: exchanges ship rectangular slabs (the
        # ppermute payload), so the diamond-norm optimization is moot
        self._l1_norm = int(norm)

    # -- storage ----------------------------------------------------------

    def is_storage_allocated(self) -> bool:
        ctx = self._ctx
        return ctx._state is not None and self._name in ctx._state

    def _ring(self) -> List:
        if not self.is_storage_allocated():
            raise YaskException(
                f"storage for var '{self._name}' not allocated "
                "(call prepare_solution)")
        return self._ctx._state[self._name]

    def _slot_idx(self, t: Optional[int], nslots: int) -> int:
        """Map an absolute step index to a ring slot (the reference's
        step-index wrapping, ``yk_var.hpp:820-825``)."""
        g = self._geom()
        if not (g.has_step and g.is_written):
            return 0
        cur = self._ctx._cur_step
        if t is None:
            return nslots - 1
        d = (cur - t) * self._ctx._csol.ana.step_dir
        slot = nslots - 1 - d
        if not (0 <= slot < nslots):
            if self._ctx.get_step_wrap():
                # yk_solution::set_step_wrap(true): any step index is
                # valid and wraps onto the ring (yk_var_api.hpp:95)
                return slot % nslots
            raise YaskException(
                f"step {t} of var '{self._name}' not in allocation "
                f"(current step {cur}, {nslots} slot(s))")
        return slot

    def _slot_for_step(self, t: Optional[int]) -> int:
        return self._slot_idx(t, len(self._ring()))

    def _split_indices(self, indices: Sequence[int]) -> Tuple[Optional[int], List]:
        """Split full-index list (declared dim order) into (step, rest),
        with strict bounds checking (the reference's ``check=1``
        bounds-checked access builds, ``generic_var.hpp:70-97``: indices
        must land inside the allocation — negative indices address the
        left pad explicitly, they never wrap)."""
        v = self._var()
        dims = v.get_dims()
        if len(indices) != len(dims):
            raise YaskException(
                f"var '{self._name}' needs {len(dims)} indices, "
                f"got {len(indices)}")
        t = None
        g = self._geom()
        by_dim = {}
        for d, i in zip(dims, indices):
            if d.type.value == "step":
                t = int(i)
                continue
            if d.type.value == "domain":
                idx = int(i) + g.origin[d.name]
                size = g.shape[g.axis_of(d.name)]
            else:
                idx = int(i) - g.misc_lo[d.name]
                size = g.misc_ext[d.name]
            if not (0 <= idx < size):
                raise YaskException(
                    f"index {d.name}={i} of var '{self._name}' outside "
                    f"the allocation (padded extent {size}, left pad "
                    f"{g.pads.get(d.name, (0, 0))[0] if d.type.value == 'domain' else 0})")
            by_dim[d.name] = idx
        # arrays are stored in PHYSICAL axis order (g.axes: misc first),
        # which may differ from the declared order of the index list
        rest = [by_dim[n] for n, _k in g.axes]
        return t, rest

    # -- element access (yk_var_api.hpp:700-951) ---------------------------

    def get_element(self, indices: Sequence[int]) -> float:
        t, rest = self._split_indices(indices)
        return float(self._ring()[self._slot_for_step(t)][tuple(rest)])

    def set_element(self, val: float, indices: Sequence[int],
                    strict_indices: bool = True) -> int:
        t, rest = self._split_indices(indices)
        slot = self._slot_for_step(t)
        self._ctx._update_state_array(
            self._name, slot, lambda a: _np_set(a, tuple(rest), val))
        return 1

    def add_to_element(self, val: float, indices: Sequence[int]) -> int:
        t, rest = self._split_indices(indices)
        slot = self._slot_for_step(t)
        self._ctx._update_state_array(
            self._name, slot,
            lambda a: _np_set(a, tuple(rest), a[tuple(rest)] + val))
        return 1

    # -- slice access ------------------------------------------------------

    def _slice_idx(self, first: Sequence[int], last: Sequence[int]):
        tf, rf = self._split_indices(first)
        tl, rl = self._split_indices(last)
        if tf is not None and tl is not None and tf != tl:
            raise YaskException("slice access must use a single step index")
        idx = tuple(slice(a, b + 1) for a, b in zip(rf, rl))
        return tf, idx

    def _declared_perm(self):
        """Permutation mapping physical (g.axes, misc-first) axis order
        to the var's declared dim order — the buffer layout the
        reference's slice APIs promise."""
        g = self._geom()
        phys = [n for n, _k in g.axes]
        decl = [d.name for d in self._var().get_dims()
                if d.type.value != "step"]
        return [phys.index(n) for n in decl]

    def get_elements_in_slice(self, first_indices: Sequence[int],
                              last_indices: Sequence[int]) -> np.ndarray:
        """Return a numpy copy of the box [first, last] (inclusive) in
        DECLARED dim order (arrays are stored misc-first physically)."""
        t, idx = self._slice_idx(first_indices, last_indices)
        out = _to_numpy(self._ring()[self._slot_for_step(t)][idx])
        perm = self._declared_perm()
        if perm != list(range(out.ndim)):
            out = out.transpose(perm)
        return np.array(out)

    def set_elements_in_slice(self, buf, first_indices: Sequence[int],
                              last_indices: Sequence[int]) -> int:
        data = np.asarray(buf)
        perm = self._declared_perm()
        t, idx = self._slice_idx(first_indices, last_indices)
        slot = self._slot_for_step(t)

        def upd(a):
            out = np.array(a)
            tgt = out[idx]
            # buffer arrives in DECLARED order; store physically
            decl_shape = tuple(tgt.shape[p] for p in perm)
            d = data.reshape(decl_shape)
            if perm != list(range(tgt.ndim)):
                d = d.transpose(np.argsort(perm))
            out[idx] = d
            return out
        self._ctx._update_state_array(self._name, slot, upd)
        return int(np.prod(data.shape)) if data.shape else 1

    def set_all_elements_same(self, val: float) -> None:
        for slot in range(len(self._ring())):
            self._ctx._fill_interior(self._name, slot, float(val))

    def set_elements_in_seq(self, seed: float = 0.1) -> None:
        """Fill the interior with a deterministic position-dependent
        sequence (the harness' ``-init_seed`` pattern, ``yask_main.cpp:
        239-249``). Values depend only on interior coordinates — never on
        pad geometry — so differently-padded contexts (and ``yask_tpu``'s)
        start from identical state.  The values are made in float64 on
        the state's own device, then cast."""
        for slot in range(len(self._ring())):
            self._ctx._fill_interior(
                self._name, slot,
                lambda xp, n, s=slot: (xp.arange(n, dtype=xp.float64) % 17
                                       + 1.0) * (seed * (s + 1)))

    # -- reductions (yk_var_api.hpp:992-1044) ------------------------------

    # reduction bitmasks (yk_var_api.hpp:965-977)
    yk_sum_reduction = 0x01
    yk_sum_squares_reduction = 0x02
    yk_product_reduction = 0x04
    yk_max_reduction = 0x08
    yk_min_reduction = 0x10

    def reduce_elements_in_slice(self, op, first_indices, last_indices):
        """Reduce a slice.  ``op`` may be a name ('sum', 'product',
        'min', 'max') returning a float, or a bitmask of the
        ``yk_*_reduction`` constants returning a
        :class:`yk_reduction_result` (the reference form,
        ``yk_var_api.hpp:1060``)."""
        data = self.get_elements_in_slice(first_indices, last_indices)
        data64 = data.astype(np.float64)
        if isinstance(op, str):
            if op in ("sum", "add"):
                return float(data64.sum())
            if op in ("product", "mul"):
                return float(data64.prod())
            if op == "min":
                return float(data64.min())
            if op == "max":
                return float(data64.max())
            raise YaskException(f"unknown reduction '{op}'")
        return yk_reduction_result(int(op), data64)

    def sum_elements_in_slice(self, first_indices, last_indices) -> float:
        return self.reduce_elements_in_slice("sum", first_indices, last_indices)

    def _whole_slice(self):
        names = self.get_dim_names()
        first = [self.get_first_local_index(d) for d in names]
        last = [self.get_last_local_index(d) for d in names]
        # reductions cover the owned domain (not pads: ghost zeros would
        # poison products/mins)
        for i, d in enumerate(names):
            if d in self.get_domain_dim_names():
                first[i] = self.get_first_rank_domain_index(d)
                last[i] = self.get_last_rank_domain_index(d)
        v = self._var()
        if v.step_dim() is not None:
            si = names.index(v.step_dim().name)
            # the NEWEST step is cur_step regardless of step direction
            first[si] = last[si] = self._ctx._cur_step
        return first, last

    def get_sum(self) -> float:
        f, l = self._whole_slice()
        return self.reduce_elements_in_slice("sum", f, l)

    def get_sum_squares(self) -> float:
        f, l = self._whole_slice()
        data = self.get_elements_in_slice(f, l).astype(np.float64)
        return float((data * data).sum())

    def get_product(self) -> float:
        f, l = self._whole_slice()
        return self.reduce_elements_in_slice("product", f, l)

    def get_max(self) -> float:
        f, l = self._whole_slice()
        return self.reduce_elements_in_slice("max", f, l)

    def get_min(self) -> float:
        f, l = self._whole_slice()
        return self.reduce_elements_in_slice("min", f, l)

    # -- storage parity (yk_var_api.hpp storage section) ----------------

    def get_num_storage_elements(self) -> int:
        g = self._geom()
        per = 1
        for e in g.shape:
            per *= int(e)
        return per * g.num_slots

    def get_num_storage_bytes(self) -> int:
        return self.get_num_storage_elements() \
            * np.dtype(self._ctx._program.dtype).itemsize

    def get_raw_storage_buffer(self) -> np.ndarray:
        """Host copy of the newest ring slot's padded array."""
        return _to_numpy(self._ring()[-1])

    def is_storage_layout_identical(self, other: "yk_var") -> bool:
        a, b = self._geom(), other._geom()
        return a.axes == b.axes and tuple(a.shape) == tuple(b.shape) \
            and a.num_slots == b.num_slots

    # -- misc --------------------------------------------------------------

    def format_indices(self, indices: Sequence[int]) -> str:
        dims = self.get_dim_names()
        return ", ".join(f"{d}={i}" for d, i in zip(dims, indices))

    def __repr__(self):
        return f"<yk_var '{self._name}'>"


def _to_numpy(a) -> np.ndarray:
    """A host numpy view/copy of a state array (tensor or numpy; a 0-dim
    numpy array indexed by ``()`` is a numpy scalar).  A bfloat16 tensor
    widens to float32, which holds its values exactly."""
    if isinstance(a, (np.ndarray, np.generic)):
        return np.asarray(a)
    import torch
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.detach().cpu().numpy()


class yk_reduction_result:
    """Result of a mask-form ``reduce_elements_in_slice``
    (``yk_var_api.hpp:983``): reductions are computed in f64 regardless
    of the solution precision; asking for one that was not in the mask
    raises."""

    def __init__(self, mask: int, data64: "np.ndarray"):
        self._mask = mask
        self._n = int(data64.size)
        self._vals = {}
        if mask & yk_var.yk_sum_reduction:
            self._vals["sum"] = float(data64.sum())
        if mask & yk_var.yk_sum_squares_reduction:
            self._vals["sum_squares"] = float((data64 * data64).sum())
        if mask & yk_var.yk_product_reduction:
            self._vals["product"] = float(data64.prod()) if self._n else 1.0
        if mask & yk_var.yk_max_reduction:
            self._vals["max"] = float(data64.max()) if self._n \
                else -float("inf")
        if mask & yk_var.yk_min_reduction:
            self._vals["min"] = float(data64.min()) if self._n \
                else float("inf")

    def get_reduction_mask(self) -> int:
        return self._mask

    def get_num_elements_reduced(self) -> int:
        return self._n

    def _get(self, key):
        if key not in self._vals:
            raise YaskException(f"reduction '{key}' was not requested")
        return self._vals[key]

    def get_sum(self) -> float:
        return self._get("sum")

    def get_sum_squares(self) -> float:
        return self._get("sum_squares")

    def get_product(self) -> float:
        return self._get("product")

    def get_max(self) -> float:
        return self._get("max")

    def get_min(self) -> float:
        return self._get("min")


def _np_set(a, idx, val):
    out = np.array(a)
    out[idx] = val
    return out


class FixedSizeVar:
    """A runtime-created var outside any solution (``yk_solution::
    new_fixed_size_var``, reference fixed-size vars ``yk_var.hpp``): plain
    N-D storage with the element/slice API, used for staging user data.
    Not part of the step program."""

    def __init__(self, name: str, dim_names: List[str],
                 dim_sizes: List[int], dtype=np.float32):
        if len(dim_names) != len(dim_sizes):
            raise YaskException("dim names/sizes length mismatch")
        self._name = name
        self._dims = list(dim_names)
        self._arr = np.zeros(tuple(int(s) for s in dim_sizes), dtype=dtype)

    def get_name(self) -> str:
        return self._name

    def get_num_dims(self) -> int:
        return len(self._dims)

    def get_dim_names(self) -> List[str]:
        return list(self._dims)

    def is_fixed_size(self) -> bool:
        return True

    def get_alloc_size(self, dim: str) -> int:
        return self._arr.shape[self._dims.index(dim)]

    def get_element(self, indices) -> float:
        return float(self._arr[tuple(int(i) for i in indices)])

    def set_element(self, val: float, indices) -> int:
        self._arr[tuple(int(i) for i in indices)] = val
        return 1

    def get_elements_in_slice(self, first_indices, last_indices) -> np.ndarray:
        idx = tuple(slice(int(a), int(b) + 1)
                    for a, b in zip(first_indices, last_indices))
        return np.array(self._arr[idx])

    def set_elements_in_slice(self, buf, first_indices, last_indices) -> int:
        idx = tuple(slice(int(a), int(b) + 1)
                    for a, b in zip(first_indices, last_indices))
        data = np.asarray(buf)
        self._arr[idx] = data.reshape(self._arr[idx].shape)
        return int(data.size)

    def set_all_elements_same(self, val: float) -> None:
        self._arr.fill(val)

    def reduce_elements_in_slice(self, op, first_indices, last_indices):
        d = self.get_elements_in_slice(first_indices,
                                       last_indices).astype(np.float64)
        return {"sum": d.sum, "add": d.sum, "product": d.prod,
                "mul": d.prod, "min": d.min, "max": d.max}[op]()

    def as_numpy(self) -> np.ndarray:
        return self._arr
