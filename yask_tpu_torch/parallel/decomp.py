"""Domain decomposition: rank-grid factorization and geometry checks.

The port's copy of ``yask_tpu/parallel/decomp.py`` (the reference's
``setup_rank`` topology work, ``src/kernel/lib/setup.cpp:169-260``):
factorizing the rank count into an N-D grid (``get_compact_factors``,
``setup.cpp:230``), and validating that each rank's sub-domain can satisfy
its neighbours' halo reads.
"""

from __future__ import annotations

from typing import List

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.utils.idx_tuple import IdxTuple


def factorize_rank_grid(num_ranks: int, dims: List[str],
                        minor_dim_whole: bool = True) -> IdxTuple:
    """Choose an N-D rank grid for ``num_ranks`` devices.

    Like the reference's compact factorization; by default the minor-most
    (last, contiguous) dim is left unsplit so halo slabs stay contiguous
    rows."""
    t = IdxTuple({d: 1 for d in dims})
    if num_ranks == 1:
        return t
    fact_dims = dims[:-1] if (minor_dim_whole and len(dims) > 1) else dims
    sub = IdxTuple({d: 1 for d in fact_dims})
    sub = sub.get_compact_factors(num_ranks)
    for d in fact_dims:
        t[d] = sub[d]
    return t


def validate_shard_geometry(csol, opts) -> None:
    """Each shard must be at least as wide as the ghost region it serves
    (the reference asserts rank domain ≥ halo similarly during setup)."""
    halos = csol.ana.max_halos()
    for d in csol.ana.domain_dims:
        n = opts.num_ranks[d]
        if n <= 1:
            continue
        g = opts.global_domain_sizes[d]
        if g % n != 0:
            raise YaskException(
                f"shard_map mode needs global size divisible by ranks in "
                f"dim '{d}' ({g} % {n} != 0)")
        local = g // n
        l, r = halos.get(d, (0, 0))
        if local < max(l, r):
            raise YaskException(
                f"rank domain {local} in dim '{d}' smaller than halo "
                f"{max(l, r)}")
