"""``-mode shard_pallas`` on every registered solution, on the CPU.

Each registered solution, at element sizes 4 and 2, is prepared under
``-mode shard_pallas`` with its outermost domain dim split over two CPU
devices, and runs one group of ``-wf_steps K`` sub-steps (K5's plain
version, ``plain_shard_chunk``, on CPU tensors) from a numpy-seeded
state.  K is 2, or 1 for a one-dim solution, whose only dim is the minor
one (the reference's ``check_shard_pallas`` refuses a sharded minor dim
at K > 1).  The split dim is sized so that each shard holds the fused
ghost width ``radius × K`` and its widest halo (a scratch var's write
halo included, ``decomp``'s rule), the other dims stay small: none of the
reference's own rejections applies, so every solution must run.  Its
result is finite and bit-equal to the port's single-domain
``-mode fused`` (K1 or K6's plain version) over the same steps; a
solution without equations launches nothing and advances its step.
"""

import pytest

import yask_tpu_torch
from yask_tpu_torch.compiler.solution_base import (create_solution,
                                                   get_registered_solutions)
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_k5_arms import bit_equal, finite
from test_torch_lowering import seeded_interiors


def k5_ctx(name, eb, mode):
    """``name`` at ``eb`` bytes per element, prepared under ``mode`` with
    the outermost domain dim split in two (``-mode shard_pallas``) or on
    one CPU device; returns (context, K)."""
    fac = yask_tpu_torch.yk_factory()
    src = create_solution(name)
    src.get_soln().set_element_bytes(eb)
    probe = fac.new_solution(fac.new_env(device="cpu"), src)
    dims = probe._ana.domain_dims
    rad = probe._ana.fused_step_radius()
    K = 2 if len(dims) > 1 else 1
    d0 = dims[0]
    g = 6 if len(dims) > 3 else 8
    sizes = {d: g for d in dims}
    sizes[d0] = 2 * max(g, rad.get(d0, 0) * K,
                        *probe._ana.max_halos().get(d0, (0, 0)))
    n = 2 if mode == "shard_pallas" else 1
    src = create_solution(name)
    src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * n), src)
    cli = " ".join(f"-g_{d} {v}" for d, v in sizes.items())
    nr = f"-nr_{d0} 2" if mode == "shard_pallas" else ""
    ctx.apply_command_line_options(f"{cli} -mode {mode} -wf_steps {K} {nr}")
    ctx.prepare_solution()
    return ctx, K


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("name", get_registered_solutions())
def test_shard_pallas_runs_every_registered_solution(name, eb):
    outs = {}
    for mode in ("shard_pallas", "fused"):
        ctx, K = k5_ctx(name, eb, mode)
        import_interiors(ctx, seeded_interiors(ctx, 5))
        ctx.run_solution(0, K - 1)
        if mode == "shard_pallas":
            assert ctx.get_stats().get_tiling()["kernel"] == "shard_step"
        outs[mode] = export_interiors(ctx)
    assert outs["shard_pallas"].keys() == outs["fused"].keys()
    assert finite(outs["shard_pallas"])
    assert bit_equal(outs["shard_pallas"], outs["fused"])
