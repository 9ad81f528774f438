"""K7's C entry point (``<name>_batched``) on every arm, built for the
host with g++: ``host_step`` and ``host_stages`` run each member in turn
through the same ``cell_base`` (member stride plus the outer cell's
offset) and the same ``call_batched_entry`` marshalling the card uses.

Each arm on a ragged grid, 2 members, two sub-steps from random states
whose read-only inputs carry nonzero pads (a scratch var is computed
past the domain and reads them), into NaN-filled outputs (a var with
unwritten misc slices starts from a copy of every member's evicted slot,
as ``copy_base`` makes it):

* against ``plain_batched_chunk``: bit-equal over each member's interior,
  the pads untouched (K6's flat arm writes them: zeros); tti by rtol 1e-5 and atol 1e-6, since g++'s libm
  ``sinf``/``cosf`` and PyTorch's vectorized CPU ``sin``/``cos`` differ by
  an ulp (as in tests/test_torch_scratch.py);
* against the solo entry of the same build on each member's view:
  bit-equal, pads included (a member of a batch gets a solo launch's
  bits).
"""

import ctypes

import pytest

from yask_tpu_torch.ops import fused_stencil

from test_torch_fused import host_kernel
from test_torch_k7_arms import port_ctx
from test_torch_scratch import with_pads

#: per arm of tests/test_torch_k7_arms.py: a ragged grid (several blocks
#: in every tiled slot, a partial last one)
RAGGED = {"scratch-tti": "-g_x 5 -g_y 9 -g_z 70",
          "rewrite-awp": "-g_x 5 -g_y 9 -g_z 70",
          "stages-ssg": "-g_x 9 -g_y 9 -g_z 70",
          "misc-gaussian": "-g_x 9 -g_y 70",
          "misc-test_misc_2d": "-g_x 9 -g_y 70",
          "partial-partial_written": "-g_x 5 -g_y 9 -g_z 70",
          "bf16-iso3dfd": "-g_x 9 -g_y 9 -g_z 70",
          "4d-test_4d": "-g_w 3 -g_x 9 -g_y 11 -g_z 70",
          "4d-four_d_stages": "-g_w 3 -g_x 5 -g_y 9 -g_z 70"}
#: members per batch
NM = 2
#: (rtol, atol) against the plain version: 0 but for tti's libm calls
PLAIN_TOL = {"scratch-tti": (1e-5, 1e-6)}


def batch_of(arm: str, seed: int = 31):
    """A prepared context of the arm at its ragged grid and NM members'
    states stacked as (NM, *shape), each with random interiors and
    nonzero pads on its read-only inputs."""
    ctx = port_ctx(arm, RAGGED[arm])
    ens = ctx.new_ensemble(NM)
    for i in range(NM):
        with ens.member(i) as c:
            with_pads(c, seed + i)
    return ctx, ens._stack_states()


def bind(so, entry: str, walks: bool = False):
    """Another entry point of a built library (``so``: its path; ``walks``:
    the workspace or flat arm's signature, ``KernelSpec.walks``)."""
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = (fused_stencil.batched_argtypes(walks)
                   if entry.endswith("_batched")
                   else fused_stencil.entry_argtypes(walks))
    fn.restype = ctypes.c_int
    return fn


def padded(a, pad: int):
    """``a`` (a stack) copied into a stack whose members sit ``pad``
    elements further apart than their size: a member stride that is not
    the product of the extents and strides of the outer and inner dims."""
    import torch
    per = a[0].numel()
    big = torch.full((a.shape[0], per + pad), float("nan"), dtype=a.dtype)
    out = big.as_strided(tuple(a.shape), (per + pad,) + a[0].stride())
    out.copy_(a)
    return out


def k7_outputs(kern, state, nm: int, pad: int = 0):
    """One sub-step's output stacks as the wrapper makes them, NaN-filled
    (a var with unwritten misc slices: a copy of each member's evicted
    slot), its members ``pad`` elements apart."""
    import torch
    prog, spec = kern.program, kern.spec
    dtype = state[spec.inputs[0][0]][0].dtype
    outs = [state[n][0].clone() if n in spec.base_outputs else
            torch.full((nm,) + tuple(prog.geoms[n].shape), float("nan"),
                       dtype=dtype) for n in spec.outputs]
    return [padded(o, pad) for o in outs] if pad else outs


def k7_steps(ctx, state, fn_batched, fn_solo, steps: int = 2,
             pad: int = 0, tol=(0.0, 0.0)) -> None:
    """``steps`` sub-steps of K7's entry from the plain version's states,
    each member's outputs held against ``plain_batched_chunk`` (interior,
    ``tol``) and against the solo entry on its view (to the bit); one
    resident block walks every tile where the flat arm runs emulated."""
    import torch
    kern = ctx._fused_spec_kernel()
    prog, spec = kern.program, kern.spec
    for t in range(steps):
        ins = [state[n][s] for n, s in spec.inputs]
        if pad:
            ins = [padded(a, pad) for a in ins]
        outs = k7_outputs(kern, state, NM, pad)
        assert fused_stencil.call_batched_entry(
            fn_batched, prog, spec, ins, outs, NM, t, None, nres=1) == 0
        want = fused_stencil.plain_batched_chunk(prog, state, t, 1, NM)
        for i in range(NM):
            member = {n: [a[i] for a in ring] for n, ring in state.items()}
            solo = [o[i].clone() for o in k7_outputs(kern, state, NM)]
            assert fused_stencil.call_entry(
                fn_solo, prog, spec, [member[n][s] for n, s in spec.inputs],
                solo, t, None, nres=1) == 0
            for n, o, s in zip(spec.outputs, outs, solo):
                idx = ctx._interior_idx(n)
                torch.testing.assert_close(o[i], s, rtol=0, atol=0,
                                           equal_nan=True)
                torch.testing.assert_close(
                    o[i][idx], want[n][-1][i][idx], rtol=tol[0],
                    atol=tol[1])
                if spec.flat and n not in spec.base_outputs:
                    # the flat arm writes every cell, its pads with 0
                    assert int((o[i] != 0).sum()) == \
                        int((o[i][idx] != 0).sum())
                elif n not in spec.base_outputs:
                    # every interior cell written, no pad cell
                    assert int(torch.isnan(o[i]).sum()) == \
                        o[i].numel() - o[i][idx].numel()
        state = want


@pytest.mark.parametrize("arm", list(RAGGED))
def test_k7_host_entry_matches_plain_and_solo(arm, tmp_path):
    ctx, state = batch_of(arm)
    spec = ctx._fused_spec_kernel().spec
    assert (f"YT_FUSED_WS_ENTRIES({spec.name}, Spec)" if spec.walks else
            f"YT_FUSED_BATCHED_ENTRY({spec.name}_batched, Spec)") \
        in spec.source
    fn_solo = host_kernel(spec, tmp_path)
    fn_batched = bind(tmp_path / f"{spec.name}.so", spec.name + "_batched",
                      spec.walks)
    k7_steps(ctx, state, fn_batched, fn_solo,
             tol=PLAIN_TOL.get(arm, (0.0, 0.0)))
