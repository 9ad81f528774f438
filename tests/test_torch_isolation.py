"""The port stands alone: it imports neither ``jax`` nor any module of
``yask_tpu``, and it never carries on silently on the CPU."""

import ast
import json
import os
import subprocess
import sys

import pytest

import yask_tpu_torch
from yask_tpu_torch.utils.exceptions import YaskException

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(yask_tpu_torch.__file__))

MAIN_PATH = r"""
import json, sys
from yask_tpu_torch import yk_factory
from yask_tpu_torch.runtime.init_utils import init_solution_vars
fac = yk_factory()
env = fac.new_env(device="cpu")
for mode in ("torch", "fused", "ref"):
    ctx = fac.new_solution(env, stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options(f"-g 8 -mode {mode} -wf_steps 2")
    ctx.prepare_solution()
    init_solution_vars(ctx)
    ctx.run_solution(0, 2)
    ctx.get_stats()
from yask_tpu_torch.main import run_harness
import io
assert run_harness(["-stencil", "3axis", "-g", "8", "-validate",
                    "-device", "cpu"], out=io.StringIO()) == 0
import yask_tpu_torch.transfer, yask_tpu_torch.ops._build
import tempfile
import yask_tpu_torch.obs, yask_tpu_torch.resilience
import yask_tpu_torch.runtime.ensemble, yask_tpu_torch.serve.resident
from yask_tpu_torch.serve import StencilServer
srv = StencilServer(env, journal_path=tempfile.mkdtemp() + "/SERVE.jsonl",
                    window_secs=0.0)
sid = srv.open_session(stencil="iso3dfd", radius=2, g=8, mode="fused",
                       wf=2, bucket=False)
srv.init_vars(sid)
assert srv.run(sid, 0, 1, timeout=120).ok
srv.shutdown()
from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain
pipe = SolutionPipeline(env, *rtm_chain(radius=2, accumulate=False))
pipe.apply_command_line_options("-g 8 -mode fused -wf_steps 1")
pipe.prepare(fuse=True)
assert pipe.pushed_vars() == {"img__img"}
pipe.run(0, 1)
for name, K, forced in (("iso3dfd", 4, True), ("wave2d", 2, False)):
    ctx = fac.new_solution(env, stencil=name, radius=2)
    if forced:   # K4 past its gate, as build_pallas_chunk(trapezoid=True)
        ctx._trapezoid_arg = lambda: True
    ctx.apply_command_line_options(f"-g 24 -wf_steps {K} -trapezoid "
                                   "-mode fused")
    ctx.prepare_solution()
    init_solution_vars(ctx)
    ctx.run_solution(0, 4)
    assert ctx.get_stats().get_tiling()["reasons"]
import yask_tpu_torch.ops.tile_planner, yask_tpu_torch.stencils.physics2d
for cli in ("-skew", "-no-skew", "-skew -skew_dims 0"):   # K1's two arms
    ctx = fac.new_solution(env, stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options(f"-g 8 -mode fused -wf_steps 2 {cli}")
    ctx.prepare_solution()
    init_solution_vars(ctx)
    ctx.run_solution(0, 2)
    assert ctx.get_stats().get_tiling()["skew_reasons"]
for name, r in (("tti", 2), ("awp", None)):   # K6's scratch, rewrite arms
    ctx = fac.new_solution(env, stencil=name, radius=r)
    ctx.apply_command_line_options("-g 8 -mode fused -wf_steps 2")
    ctx.prepare_solution()
    init_solution_vars(ctx)
    ctx.run_solution(0, 1)
    assert ctx.get_stats().get_tiling()["kernel"] == "stages_step"
ctx = fac.new_solution(env, stencil="iso3dfd", radius=2)
ctx.apply_command_line_options("-g 8 -mode fused -wf_steps 2")
ctx.prepare_solution()
ens = ctx.new_ensemble(2)
ens.run(0, 1)
assert ens.tiling["kernel"] == "batched_step"
import yask_tpu_torch.parallel
env4 = fac.new_env(devices=["cpu"] * 4)
for mode in ("shard_map", "sharded", "shard_pallas"):
    ctx = fac.new_solution(env4, stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options(f"-g 16 -mode {mode} -wf_steps 2 "
                                   "-nr_x 2 -nr_y 2")
    ctx.prepare_solution()
    init_solution_vars(ctx)
    ctx.run_solution(0, 2)
    assert ctx.get_var("pressure").get_element([3, 8, 8, 8]) != 0
    ctx.get_stats()
from yask_tpu_torch.compiler.solution_base import create_solution
for mode in ("torch", "fused", "ref"):   # element size 2, bfloat16
    sb = create_solution("iso3dfd", radius=2)
    sb.get_soln().set_element_bytes(2)
    ctx = fac.new_solution(env, sb)
    ctx.apply_command_line_options(f"-g 8 -mode {mode} -wf_steps 2")
    ctx.prepare_solution()
    init_solution_vars(ctx)
    ctx.run_solution(0, 2)
    assert ctx.get_var("pressure").get_element([3, 4, 4, 4]) != 0
for name in ("gaussian", "test_misc_2d"):   # the misc arm
    ctx = fac.new_solution(env, stencil=name)
    ctx.apply_command_line_options("-g 8 -mode fused -wf_steps 2")
    ctx.prepare_solution()
    init_solution_vars(ctx)
    ctx.run_solution(0, 1)
print(json.dumps(sorted(m for m in sys.modules
                        if m in ("jax", "ml_dtypes") or m.startswith("jax.")
                        or m.startswith("ml_dtypes.")
                        or (m.startswith("yask_tpu")
                            and m.split(".")[0] != "yask_tpu_torch"))))
"""


def test_main_path_loads_no_jax_and_no_yask_tpu():
    """The main path, and its element-size-2 runs, load neither JAX, nor
    ``yask_tpu``, nor ``ml_dtypes``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", MAIN_PATH], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def _py_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return files


def test_no_jax_or_yask_tpu_import_in_the_port():
    bad = []
    for path in _py_files():
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "yask_tpu", "ml_dtypes"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert bad == []
    assert len(_py_files()) > 20
    # the whole stencil library, A1's copies included
    assert {f"stencils/{n}.py" for n in ("tti", "elastic", "awp", "filters",
                                         "test_stencils")} \
        <= {os.path.relpath(f, PKG).replace(os.sep, "/")
            for f in _py_files()}


def test_new_env_without_cuda_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fac = yask_tpu_torch.yk_factory()
    with pytest.raises(YaskException, match='device="cpu"'):
        fac.new_env()
    with pytest.raises(YaskException, match="no CUDA device"):
        fac.new_env(device="cuda:0")
    env = fac.new_env(device="cpu")
    assert env.get_device().type == "cpu" and env.get_platform() == "cpu"
    ctx = fac.new_solution(env, stencil="3axis", radius=1)
    ctx.apply_command_line_options("-g 8 -device cuda:0")
    with pytest.raises(YaskException, match="-device cpu"):
        ctx.prepare_solution()


def test_harness_without_device_flag_refuses_a_cpu_only_host(monkeypatch):
    import io
    import torch
    from yask_tpu_torch.main import run_harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(YaskException, match='device="cpu"'):
        run_harness(["-stencil", "3axis", "-g", "8"], out=io.StringIO())
