"""K4's device code on the new arms, emulated on the CPU.

``csrc/trapezoid.cuh``'s ``trapezoid_kernel``/``diamond_kernel`` built
with g++ against the CUDA shim of tests/test_torch_kernel_emulation.py:
1024 threads per block taking turns from one ``__syncthreads`` to the
next, NaN-filled shared memory before every block.  The level buffers go
to the workspace (``resolve_trapezoid(smem_limit=)``), a NaN-filled
tensor: once with one tile per block (a cell a block reads before any of
its threads wrote it shows as NaN) and once with fewer resident blocks
than tiles, so each block walks several tiles of its workspace slice
between barriers.  One group against ``plain_chunk`` to the bit (tti
with tests/test_torch_scratch.py's libm tolerance), and the member batch
(``<name>_trap_batched``) against each member's solo group.
"""

import pytest

import yask_tpu_torch  # noqa: F401
from yask_tpu_torch.ops import cuda_emit, fused_stencil

from test_torch_k4_host import assert_states, k4_ctx
from test_torch_k4_arms import seeded_physical
from test_torch_kernel_emulation import emulated_kernel
from yask_tpu_torch.transfer import import_interiors


def emulated_group(fn, prog, spec, state, nres, nm=0):
    """One group through the emulated entry into NaN-filled outputs, with
    a NaN-filled workspace of ``nres`` blocks; pads re-zeroed, rings
    rotated as ``trapezoid_chunk`` does."""
    import torch
    kern = fused_stencil.TrapezoidKernel(prog, spec)
    kern.dtype = next(iter(state.values()))[0].dtype
    lead = (nm,) if nm else ()
    outs = fused_stencil.trap_outputs(kern, state, "cpu", lead)
    for n, o in zip(spec.outputs, outs):
        if n not in spec.base_outputs:
            o.fill_(float("nan"))
    esize = torch.empty((), dtype=kern.dtype).element_size()
    ws = torch.full((nres * spec.trap["ws_block_bytes"] // esize + 1,),
                    float("nan"), dtype=kern.dtype)
    ins = [state[n][s] for n, s in spec.inputs]
    for p in range(len(spec.trap["passes"])):
        rc = (fused_stencil.call_trap_batched_entry(
                  fn, prog, spec, ins, outs, p, nm, 0, None, ws, nres)
              if nm else
              fused_stencil.call_trapezoid_entry(fn, prog, spec, ins, outs,
                                                 p, 0, None, ws, nres))
        assert rc == 0
    for n, o in zip(spec.outputs, outs):
        for m in (o if nm else [o]):
            fused_stencil._zero_pads(prog, n, m)
    return fused_stencil._rotated(prog, spec, state, outs)


def tiles(spec, nm=1):
    return max(p["grid"][0] * p["grid"][1] * p["grid"][2]
               for p in spec.trap["passes"]) * nm


@pytest.mark.parametrize("name,r,sizes,eb,lim", [
    ("tti", 2, (18, 18, 8), 4, 30000),
    ("ssg", None, (18, 18, 8), 4, 0),
    ("gaussian", 2, (28, 12), 4, 0),
    ("iso3dfd", 2, (34, 34, 9), 2, 0)])
def test_k4_new_arms_match_plain_when_emulated(name, r, sizes, eb, lim,
                                               tmp_path):
    K = 2
    ctx = k4_ctx(name, r, sizes, K, eb)
    prog = ctx._program
    spec = cuda_emit.resolve_trapezoid(prog, K, True, smem_limit=lim)
    assert spec.trap["ws_block_bytes"] > 0
    fn = emulated_kernel(spec, tmp_path)
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, K)
    tol = dict(rtol=1e-5, atol=1e-6) if name == "tti" else {}
    for nres in (tiles(spec), 2):
        assert_states(emulated_group(fn, prog, spec, ctx._state, nres),
                      want, **tol)


def test_k4_member_batch_matches_solo_when_emulated(tmp_path):
    import torch
    K, nm = 2, 2
    ctxs = [k4_ctx("tti", 2, (18, 18, 8), K) for _ in range(nm)]
    for i, c in enumerate(ctxs):
        import_interiors(c, seeded_physical(c, 30 + i))
    prog = ctxs[0]._program
    spec = cuda_emit.resolve_trapezoid(prog, K, True, smem_limit=30000)
    fn = emulated_kernel(spec, tmp_path)
    # one library, both entries
    import ctypes
    bfn = getattr(ctypes.CDLL(str(tmp_path / f"{spec.name}.so")),
                  spec.name + "_trap_batched")
    bfn.argtypes = fused_stencil.trap_batched_argtypes()
    bfn.restype = ctypes.c_int
    stacked = {n: [torch.stack([c._state[n][s] for c in ctxs])
                   for s in range(len(ring))]
               for n, ring in ctxs[0]._state.items()}
    got = emulated_group(bfn, prog, spec, stacked, 3, nm=nm)
    for i, c in enumerate(ctxs):
        solo = emulated_group(fn, prog, spec, c._state, tiles(spec))
        assert_states({n: [a[i] for a in ring] for n, ring in got.items()},
                      solo)


def test_k4_emulation_fails_with_a_stage_region_one_cell_short(tmp_path):
    """A mutation check: sub-stage regions one cell narrower than K6's
    expansions leave cells a later sub-stage reads unwritten (NaN in the
    workspace), and the emulated group no longer matches."""
    K = 2
    ctx = k4_ctx("tti", 2, (18, 18, 8), K)
    prog = ctx._program
    spec = cuda_emit.resolve_trapezoid(prog, K, True, smem_limit=0)

    def narrower(fn, text):
        if fn != "trapezoid.cuh":
            return text
        old = "constexpr int lo0 = S::reg_lo(P, 0, L) - S::sub_lo(Q, 0);"
        assert old in text
        return text.replace(old, "constexpr int lo0 = S::reg_lo(P, 0, L) "
                                 "- S::sub_lo(Q, 0) + (S::sub_lo(Q, 0) > 0);")
    fn = emulated_kernel(spec, tmp_path, edit=narrower)
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, K)
    with pytest.raises(AssertionError):
        assert_states(emulated_group(fn, prog, spec, ctx._state,
                                     tiles(spec)), want,
                      rtol=1e-5, atol=1e-6)


def test_k4_member_batch_walks_its_z_cells_when_emulated(tmp_path):
    """Every buffer in shared memory (one block per tile): a member batch's
    z cells (members x slot-0 tiles) walked two at a time
    (``YT_MAX_GRID_Z`` = 2), each member bit-equal to its solo group."""
    import ctypes
    import torch
    K, nm = 2, 3
    ctxs = [k4_ctx("iso3dfd", 2, (34, 34, 9), K) for _ in range(nm)]
    for i, c in enumerate(ctxs):
        import_interiors(c, seeded_physical(c, 40 + i))
    prog = ctxs[0]._program
    spec = ctxs[0]._trapezoid_kernel().spec
    assert spec.trap["ws_block_bytes"] == 0
    assert spec.trap["passes"][0]["grid"][0] * nm > 2
    fn = emulated_kernel(spec, tmp_path, defines={"YT_MAX_GRID_Z": 2})
    bfn = getattr(ctypes.CDLL(str(tmp_path / f"{spec.name}.so")),
                  spec.name + "_trap_batched")
    bfn.argtypes = fused_stencil.trap_batched_argtypes()
    bfn.restype = ctypes.c_int
    stacked = {n: [torch.stack([c._state[n][s] for c in ctxs])
                   for s in range(len(ring))]
               for n, ring in ctxs[0]._state.items()}
    got = emulated_group(bfn, prog, spec, stacked, 0, nm=nm)
    for i, c in enumerate(ctxs):
        assert_states({n: [a[i] for a in ring] for n, ring in got.items()},
                      fused_stencil.plain_chunk(prog, c._state, 0, K))
    assert_states(emulated_group(fn, prog, spec, ctxs[0]._state, 0),
                  fused_stencil.plain_chunk(prog, ctxs[0]._state, 0, K))
