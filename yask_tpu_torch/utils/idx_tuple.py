"""Ordered named-dimension tuples — the backbone of all size/index math.

TPU-native counterpart of the reference's ``Tuple<T>`` / ``IdxTuple``
(``src/common/tuple.hpp:130``, ``tuple.cpp``): an ordered map from dimension
name to integer value with elementwise arithmetic, N-D↔1-D layout math,
products, compact factorization (used for device-mesh grids the way the
reference uses it for MPI rank grids, ``setup.cpp:230``), and string
formatting.

Implemented in Python (dicts are ordered).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from yask_tpu_torch.utils.exceptions import YaskException


class IdxTuple:
    """Ordered map of dimension name → int value.

    Construction::

        IdxTuple(x=4, y=5, z=6)
        IdxTuple({"x": 4, "y": 5})
        IdxTuple([("x", 4), ("y", 5)])
    """

    __slots__ = ("_map", "_first_inner")

    def __init__(self, arg=None, first_inner: bool = False, **kwargs):
        self._map: Dict[str, int] = {}
        # Layout convention: last dim is unit-stride ("inner") by default, as
        # on TPU where the minor-most axis maps to the 128-lane register dim.
        self._first_inner = first_inner
        if arg is not None:
            if isinstance(arg, IdxTuple):
                self._map.update(arg._map)
            elif isinstance(arg, dict):
                self._map.update(arg)
            else:
                for name, val in arg:
                    self._map[name] = val
        self._map.update(kwargs)
        for k, v in self._map.items():
            if not isinstance(k, str):
                raise YaskException(f"IdxTuple dim name {k!r} is not a string")
            self._map[k] = int(v)

    # ---- basic accessors -------------------------------------------------

    def get_num_dims(self) -> int:
        return len(self._map)

    def get_dim_names(self) -> List[str]:
        return list(self._map.keys())

    def get_vals(self) -> List[int]:
        return list(self._map.values())

    def has_dim(self, name: str) -> bool:
        return name in self._map

    def get_dim_posn(self, name: str) -> int:
        try:
            return self.get_dim_names().index(name)
        except ValueError:
            raise YaskException(f"dimension '{name}' not in {self}") from None

    def get_dim_name(self, posn: int) -> str:
        return self.get_dim_names()[posn]

    def __getitem__(self, key) -> int:
        if isinstance(key, int):
            return self.get_vals()[key]
        if key not in self._map:
            raise YaskException(f"dimension '{key}' not in {self}")
        return self._map[key]

    def get(self, key: str, default: Optional[int] = None) -> Optional[int]:
        return self._map.get(key, default)

    def __setitem__(self, key, val) -> None:
        if isinstance(key, int):
            key = self.get_dim_name(key)
        if key not in self._map:
            raise YaskException(f"dimension '{key}' not in {self}")
        self._map[key] = int(val)

    def add_dim_back(self, name: str, val: int) -> "IdxTuple":
        if name in self._map:
            raise YaskException(f"duplicate dimension '{name}'")
        self._map[name] = int(val)
        return self

    def add_dim_front(self, name: str, val: int) -> "IdxTuple":
        if name in self._map:
            raise YaskException(f"duplicate dimension '{name}'")
        new = {name: int(val)}
        new.update(self._map)
        self._map = new
        return self

    def remove_dim(self, name: str) -> "IdxTuple":
        self._map.pop(name, None)
        return self

    def set_vals_same(self, val: int) -> "IdxTuple":
        for k in self._map:
            self._map[k] = int(val)
        return self

    def set_vals(self, other: "IdxTuple", add_missing: bool = False) -> "IdxTuple":
        """Copy values from ``other`` for dims present here (optionally add)."""
        for k, v in other.items():
            if k in self._map:
                self._map[k] = int(v)
            elif add_missing:
                self._map[k] = int(v)
        return self

    def items(self) -> Iterable[Tuple[str, int]]:
        return self._map.items()

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def copy(self) -> "IdxTuple":
        return IdxTuple(self._map, first_inner=self._first_inner)

    # ---- reductions ------------------------------------------------------

    def product(self) -> int:
        p = 1
        for v in self._map.values():
            p *= v
        return p

    def sum(self) -> int:
        return sum(self._map.values())

    def max_val(self) -> int:
        return max(self._map.values())

    def min_val(self) -> int:
        return min(self._map.values())

    # ---- elementwise math ------------------------------------------------

    def _map_elements(self, op: Callable[[int, int], int], other) -> "IdxTuple":
        out = self.copy()
        if isinstance(other, IdxTuple):
            for k in out._map:
                if other.has_dim(k):
                    out._map[k] = op(out._map[k], other[k])
        else:
            for k in out._map:
                out._map[k] = op(out._map[k], int(other))
        return out

    def add_elements(self, other) -> "IdxTuple":
        return self._map_elements(lambda a, b: a + b, other)

    def sub_elements(self, other) -> "IdxTuple":
        return self._map_elements(lambda a, b: a - b, other)

    def mult_elements(self, other) -> "IdxTuple":
        return self._map_elements(lambda a, b: a * b, other)

    def min_elements(self, other) -> "IdxTuple":
        return self._map_elements(min, other)

    def max_elements(self, other) -> "IdxTuple":
        return self._map_elements(max, other)

    __add__ = add_elements
    __sub__ = sub_elements
    __mul__ = mult_elements

    def map_elements(self, fn: Callable[[int], int]) -> "IdxTuple":
        out = self.copy()
        for k in out._map:
            out._map[k] = int(fn(out._map[k]))
        return out

    # ---- comparisons -----------------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, IdxTuple):
            return NotImplemented
        return self._map == other._map

    def __hash__(self) -> int:
        return hash(tuple(self._map.items()))

    def are_dims_same(self, other: "IdxTuple", same_order: bool = True) -> bool:
        if same_order:
            return self.get_dim_names() == other.get_dim_names()
        return set(self.get_dim_names()) == set(other.get_dim_names())

    # ---- layout math (N-D ↔ 1-D) ----------------------------------------

    def layout(self, offsets: "IdxTuple") -> int:
        """Map an N-D point to a 1-D offset within this tuple's sizes.

        Counterpart of ``Tuple::layout`` (``tuple.hpp``). With the default
        last-inner convention the last dim is unit stride.
        """
        names = self.get_dim_names()
        if self._first_inner:
            names = list(reversed(names))
        idx = 0
        for name in names:  # outer → inner
            size = self._map[name]
            ofs = offsets[name]
            if not (0 <= ofs < size):
                raise YaskException(
                    f"offset {name}={ofs} out of bounds for size {size}")
            idx = idx * size + ofs
        return idx

    def unlayout(self, offset: int) -> "IdxTuple":
        """Inverse of :meth:`layout`: 1-D offset → N-D point."""
        if not (0 <= offset < max(self.product(), 1)):
            raise YaskException(f"1-D offset {offset} out of bounds for {self}")
        names = self.get_dim_names()
        if not self._first_inner:
            names = list(reversed(names))
        out = self.copy()
        for name in names:  # inner → outer
            size = self._map[name]
            out._map[name] = offset % size
            offset //= size
        return out

    def strides(self) -> "IdxTuple":
        """Per-dim 1-D stride under this layout."""
        names = self.get_dim_names()
        if self._first_inner:
            names_in_order = names
        else:
            names_in_order = list(reversed(names))
        out = self.copy()
        stride = 1
        for name in names_in_order:  # inner → outer
            out._map[name] = stride
            stride *= self._map[name]
        return out

    def visit_all_points(self) -> Iterator["IdxTuple"]:
        """Yield every point in the box ``[0, size)`` per dim, inner fastest."""
        n = self.product()
        for i in range(n):
            yield self.unlayout(i)

    # ---- factorization ---------------------------------------------------

    def get_compact_factors(self, n: int) -> "IdxTuple":
        """Factorize ``n`` into this tuple's dims as compactly as possible.

        Counterpart of ``get_compact_factors`` (reference ``setup.cpp:230``),
        used there to choose an MPI rank grid and here to choose a device-mesh
        grid: among all factorizations of ``n`` over the dims, pick the one
        minimizing the spread (max/min ratio), preferring larger factors in
        later (inner) dims to keep the minor axis long for TPU lanes.
        """
        ndims = self.get_num_dims()
        if ndims == 0:
            if n != 1:
                raise YaskException("cannot factorize into 0 dims")
            return self.copy()

        best: Optional[List[int]] = None
        best_score: Optional[Tuple[float, int]] = None

        def rec(rem: int, dims_left: int, acc: List[int]):
            nonlocal best, best_score
            if dims_left == 1:
                cand = acc + [rem]
                # Spread (lower better), then prefer increasing factors so the
                # inner-most (last) dim gets the biggest factor.
                spread = max(cand) / max(min(cand), 1)
                sortedness = sum(
                    1 for a, b in zip(cand, cand[1:]) if a > b)
                score = (spread, sortedness)
                if best_score is None or score < best_score:
                    best_score = score
                    best = cand
                return
            for f in range(1, rem + 1):
                if rem % f == 0:
                    rec(rem // f, dims_left - 1, acc + [f])

        rec(n, ndims, [])
        if best is None:
            raise YaskException(f"cannot factorize {n} into {ndims} dims")
        out = self.copy()
        for name, val in zip(out.get_dim_names(), best):
            out._map[name] = val
        return out

    # ---- formatting ------------------------------------------------------

    def make_dim_val_str(self, sep: str = ", ", infix: str = "=") -> str:
        return sep.join(f"{k}{infix}{v}" for k, v in self._map.items())

    def make_dim_str(self, sep: str = ", ") -> str:
        return sep.join(self._map.keys())

    def make_val_str(self, sep: str = ", ") -> str:
        return sep.join(str(v) for v in self._map.values())

    def __repr__(self) -> str:
        return f"IdxTuple({self.make_dim_val_str()})"

    def __str__(self) -> str:
        return "{" + self.make_dim_val_str() + "}"


def parse_dim_val_str(s: str) -> IdxTuple:
    """Parse ``"x=4,y=5"`` into an IdxTuple (inverse of make_dim_val_str)."""
    out = IdxTuple()
    s = s.strip()
    if not s:
        return out
    for part in s.split(","):
        part = part.strip()
        if "=" in part:
            k, v = part.split("=", 1)
            out.add_dim_back(k.strip(), int(v))
        else:
            raise YaskException(f"cannot parse dim=val from '{part}'")
    return out


def n_choose_k(n: int, k: int) -> int:
    """Binomial coefficient (counterpart of ``src/common/combo.cpp``)."""
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def combination_at(n: int, k: int, index: int) -> List[int]:
    """Return the ``index``-th k-combination of ``range(n)`` in lexicographic
    order (counterpart of the enumeration helpers in ``combo.cpp``)."""
    if not (0 <= index < n_choose_k(n, k)):
        raise YaskException("combination index out of range")
    out: List[int] = []
    start = 0
    for slot in range(k):
        for v in range(start, n):
            c = n_choose_k(n - v - 1, k - slot - 1)
            if index < c:
                out.append(v)
                start = v + 1
                break
            index -= c
    return out
