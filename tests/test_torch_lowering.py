"""The port's ``torch`` mode (StepProgram on tensors, CPU) against
yask_tpu's ``jit`` and ``ref`` modes, and the port's ``ref`` against
yask_tpu's ``ref``.  Both packages start from the same numpy-seeded
interiors, installed in the port through ``yask_tpu_torch.transfer``.

Tolerance: ``compare_data``'s defaults (a point mismatches when
|x−y| > 1e-7 + 1e-4·max(|x|,|y|)); the two numpy oracles must agree
bit for bit."""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.transfer import export_interiors, import_interiors

STENCILS = [("iso3dfd", 2), ("iso3dfd_sponge", 2), ("3axis", 1),
            ("cube", 1)]
G, STEPS = 12, 3


def seeded_interiors(ctx, seed):
    """Random interiors per var and ring slot (written vars U[0,1),
    read-only coefficients 0.05 + 0.01·U), laid out like the port's."""
    rng = np.random.RandomState(seed)
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    out = {}
    for name, slots in export_interiors(ctx).items():
        out[name] = []
        for a in slots:
            v = rng.rand(*a.shape)
            out[name].append(v if name in written else 0.05 + 0.01 * v)
    return out


def tpu_import(ctx, interiors):
    """Install interiors into a yask_tpu context via its yk_var API
    (ring slot s holds step cur − (nslots−1−s))."""
    for name, slots in interiors.items():
        v = ctx.get_var(name)
        sizes = [ctx.get_overall_domain_size(d)
                 for d in v.get_domain_dim_names()]
        for s, vals in enumerate(slots):
            t = [] if not v.get_step_dim_name() else \
                [v.get_first_valid_step_index() + s]
            v.set_elements_in_slice(vals.astype(np.float32),
                                    t + [0] * len(sizes),
                                    t + [n - 1 for n in sizes])


def tpu_export(ctx):
    out = {}
    for name in ctx.get_var_names():
        v = ctx.get_var(name)
        sizes = [ctx.get_overall_domain_size(d)
                 for d in v.get_domain_dim_names()]
        steps = [None]
        if v.get_step_dim_name():
            steps = list(range(v.get_first_valid_step_index(),
                               v.get_last_valid_step_index() + 1))
        out[name] = [v.get_elements_in_slice(
            ([] if t is None else [t]) + [0] * len(sizes),
            ([] if t is None else [t]) + [n - 1 for n in sizes])
            for t in steps]
    return out


def mismatches(x, y, epsilon=1e-4, abs_epsilon=1e-7, field_epsilon=0.0):
    """compare_data's rule over two interior dicts."""
    bad = 0
    for name in x:
        for a, b in zip(x[name], y[name]):
            a = a.astype(np.float64)
            b = b.astype(np.float64)
            assert a.shape == b.shape
            tol = abs_epsilon + epsilon * np.maximum(np.abs(a), np.abs(b))
            if field_epsilon:
                tol = tol + field_epsilon * max(np.abs(a).max(),
                                                np.abs(b).max())
            bad += int((np.abs(a - b) > tol).sum())
    return bad


def run_pair(name, r, port_mode, tpu_mode, wf=1, steps=STEPS, seed=5):
    port = yask_tpu_torch.yk_factory()
    pctx = port.new_solution(port.new_env(device="cpu"), stencil=name,
                             radius=r)
    pctx.apply_command_line_options(f"-g {G} -mode {port_mode} "
                                    f"-wf_steps {wf}")
    pctx.prepare_solution()
    tpu = yask_tpu.yk_factory()
    tctx = tpu.new_solution(tpu.new_env(), stencil=name, radius=r)
    tctx.apply_command_line_options(f"-g {G} -wf_steps {wf}")
    tctx.get_settings().mode = tpu_mode
    tctx.prepare_solution()
    state = seeded_interiors(pctx, seed)
    import_interiors(pctx, state)
    tpu_import(tctx, state)
    pctx.run_solution(0, steps - 1)
    tctx.run_solution(0, steps - 1)
    return export_interiors(pctx), tpu_export(tctx)


@pytest.mark.parametrize("tpu_mode", ["jit", "ref"])
@pytest.mark.parametrize("name,r", STENCILS)
def test_torch_mode_matches_yask_tpu(name, r, tpu_mode):
    mine, theirs = run_pair(name, r, "torch", tpu_mode)
    assert set(mine) == set(theirs)
    assert mismatches(mine, theirs) == 0


@pytest.mark.parametrize("name,r", STENCILS)
def test_ref_mode_bit_identical_to_yask_tpu_ref(name, r):
    mine, theirs = run_pair(name, r, "ref", "ref")
    for n in theirs:
        for a, b in zip(mine[n], theirs[n]):
            np.testing.assert_array_equal(a, b)


def test_transfer_round_trip_keeps_pads_zero():
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="iso3dfd",
                           radius=2)
    ctx.apply_command_line_options(f"-g {G}")
    ctx.prepare_solution()
    state = seeded_interiors(ctx, 9)
    import_interiors(ctx, state)
    back = export_interiors(ctx)
    for n in state:
        for a, b in zip(state[n], back[n]):
            np.testing.assert_array_equal(a.astype(np.float32), b)
    for n, ring in ctx._state.items():
        for a in ring:
            outside = a.clone()
            outside[ctx._interior_idx(n)] = 0
            assert not outside.any()   # nothing outside the interior


def test_torch_ops_cbrt_and_scalar_functions():
    import torch
    from yask_tpu_torch.compiler.lowering import TorchOps
    ops = TorchOps("cpu")
    x = torch.tensor([-27.0, -1.0, 0.0, 8.0, 2.0])
    np.testing.assert_allclose(ops.func("cbrt", [x]).numpy(),
                               np.cbrt(x.numpy()), rtol=2e-7, atol=0)
    assert ops.func("sqrt", [4.0]) == 2.0      # constants stay Python
    assert ops.where(True, 1.0, 2.0) == 1.0
    assert ops.logical("and", True, False) is False
