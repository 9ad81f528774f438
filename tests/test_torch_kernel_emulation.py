"""The device code of K1, K6, K4 and K5 run on the CPU, block by block.

``csrc/fused_step.cuh``'s ``__global__`` kernels cannot run here (no
card, no nvcc), and the g++ host path (``host_step``/``host_stages``)
reads global memory only, so it checks the emitted arithmetic but not the
shared-memory tiles: the staging bounds, the grown halos, the expanded
stage regions and the zero ghost cells of K6's computed tiles.  This
test compiles the kernels themselves with g++ against a small CUDA shim:
each block runs with one ``std::thread`` per CUDA thread, the threads
taking turns in the order of their id from one ``__syncthreads`` to the
next (a deterministic schedule), and shared memory is a global array
filled with NaN before every block, so a read of a cell no thread wrote
shows.  ``cp.async`` (the stream arm's) leaves its destination NaN from
its issue until the issuing thread's ``cp.async.wait_group`` completes
it, so a read before the wait, or a copy into a plane still being read,
shows too.  The
launch is the wrapper's own (``call_entry``, ``call_trapezoid_entry``)
on CPU tensors.  K4's fresh outputs are NaN-filled too, so a cell that
neither phase 1's windows nor the diamond bands write shows.  Tolerance:
none — the same operations in the same order as ``plain_chunk`` (K5:
``plain_shard_chunk``).
"""

import ctypes
import os
import re
import shutil
import subprocess

import pytest

import yask_tpu_torch
from yask_tpu_torch.ops import fused_stencil
from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain
from yask_tpu_torch.transfer import import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_lowering import seeded_interiors

CSRC = os.path.join(os.path.dirname(fused_stencil.__file__), "..", "csrc")

SHIM = r"""
#pragma once
#include <cstring>
#include <memory>
#include <semaphore>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline uint3 blockIdx;
inline dim3 gridDim;
inline thread_local uint3 threadIdx;
alignas(16) inline unsigned char yt_smem_raw[232448];
// The threads of a block run one at a time in the order of their linear
// id: each runs to its next __syncthreads (or its end) and hands the turn
// to the next; the last one's hand-off releases the barrier.  A valid
// CUDA schedule, and a deterministic one: a read of a cell that another
// thread writes later in the phase, or has overwritten earlier in it,
// shows on every run.
inline std::vector<std::binary_semaphore*> yt_turn;
inline thread_local unsigned yt_tid;
inline void yt_hand_off() {
  yt_turn[(yt_tid + 1) % yt_turn.size()]->release();
}
inline void __syncthreads() {
  yt_hand_off();
  yt_turn[yt_tid]->acquire();
}
// Reads past an allocation: a test may surround its inputs with margins
// whose 4-byte words hold YT_STRAY (a NaN no arithmetic makes); every
// load (__ldg) and every filling cp.async that reads such a word counts in
// yt_stray_reads(), so a kernel that reads past an allocation shows even
// where it never uses what it read.
#include <atomic>
#include <cstdint>
#define YT_STRAY 0x7FBADBADu
inline std::atomic<long long> yt_strays{0};
inline void yt_note_reads(const void* src, int bytes) {
  for (int i = 0; i + 4 <= bytes; i += 4) {
    std::uint32_t w;
    std::memcpy(&w, static_cast<const char*>(src) + i, 4);
    if (w == YT_STRAY) ++yt_strays;
  }
}
extern "C" long long yt_stray_reads() { return yt_strays.exchange(0); }
template <class T> T __ldg(const T* p) {
  yt_note_reads(p, int(sizeof(T)));
  return *p;
}
// bfloat16: the headers' own host bf16_t (no cuda_bf16.h here)
#define YT_HOST_BF16
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= int(sizeof(yt_smem_raw)) ? 0 : 1;
}
inline cudaError_t cudaGetLastError() { return 0; }
// the resident-block query of the workspace arms and K6's flat arm: one
// SM holding one block
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          int) {
  *n = 1;
  return 0;
}
// cp.async, deferred: a copy leaves its destination undefined (NaN) from
// its issue until a wait_group of the issuing thread completes its group,
// the weakest order the card guarantees.  A copy whose source or
// destination is not aligned to its size faults on the card: here it
// never completes, so its destination stays NaN.
#define YT_CP_ASYNC_HOOKS
#include <cstdint>
#include <deque>
struct YtCopy { void* dst; const void* src; int bytes; bool fill; };
inline thread_local std::vector<YtCopy> yt_open;
inline thread_local std::deque<std::vector<YtCopy>> yt_groups;
template <int B> void cp_async(void* dst, const void* src, bool fill) {
  std::memset(dst, 0xFF, B);
  if (fill) yt_note_reads(src, B);
  if (reinterpret_cast<std::uintptr_t>(dst) % B
      || (fill && reinterpret_cast<std::uintptr_t>(src) % B))
    return;
  yt_open.push_back({dst, src, B, fill});
}
inline void cp_async_commit() {
  yt_groups.push_back(std::move(yt_open));
  yt_open.clear();
}
template <int N> void cp_async_wait() {
  while (yt_groups.size() > N) {
    for (auto& c : yt_groups.front())
      if (c.fill) std::memcpy(c.dst, c.src, c.bytes);
      else std::memset(c.dst, 0, c.bytes);
    yt_groups.pop_front();
  }
}
template <class F> void yt_emulate(dim3 grid, dim3 block, F kernel) {
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = {bx, by, bz};
        std::memset(yt_smem_raw, 0xFF, sizeof(yt_smem_raw));  // NaN
        std::vector<std::unique_ptr<std::binary_semaphore>> sems;
        yt_turn.clear();
        for (unsigned i = 0; i < block.x * block.y; ++i) {
          sems.emplace_back(new std::binary_semaphore(i == 0 ? 1 : 0));
          yt_turn.push_back(sems.back().get());
        }
        std::vector<std::thread> ts;
        for (unsigned ty = 0; ty < block.y; ++ty)
          for (unsigned tx = 0; tx < block.x; ++tx)
            ts.emplace_back([&, tx, ty] {
              threadIdx = {tx, ty, 0};
              yt_tid = ty * block.x + tx;
              yt_turn[yt_tid]->acquire();
              kernel();
              yt_hand_off();
            });
        for (auto& t : ts) t.join();
      }
}
"""


#: The kernels each header declares and launches (K1/K7/K5, K6/K7/K5 and
#: K6's flat arm in fused_step.cuh, K5 a compile-time arm of each body;
#: K4's two in trapezoid.cuh; K1's stream arm in stream_step.cuh; K6's
#: and K7's stream arm in stream_stages.cuh).
KERNELS = {"fused_step.cuh": 3, "trapezoid.cuh": 2, "stream_step.cuh": 1,
           "stream_stages.cuh": 1}


def emulated_kernel(spec, tmp_path, entry=None, edit=None, defines=None):
    """The emitted source built with g++ as device code (``__CUDACC__``
    and ``__CUDA_ARCH__`` defined) against the shim; returns its entry
    (``spec.name``, K5's ``spec.name + "_region"``, K7's ``spec.name +
    "_batched"``, the stream arm's ``spec.name + "_stream"``, or
    K6's stream arm's ``spec.name + "_stages_stream"`` and
    ``"_stages_stream_batched"``, and K5's over it,
    ``"_stages_stream_region"``).
    ``edit(file, text)`` may rewrite a header first (a deliberately broken
    kernel); ``defines`` are macros for the build (``{"YT_MAX_GRID_Z": 2}``
    walks a launch's z cells, and the stream arm's y blocks, two at a
    time)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to emulate the kernels"
    for fn, nk in KERNELS.items():
        header = open(os.path.join(CSRC, fn)).read()
        if edit is not None:
            header = edit(fn, header)
        header, n_decl = re.subn(
            r"extern __shared__ __align__\(16\) unsigned char "
            r"yt_smem_raw\[\];", "", header)
        header, n_launch = re.subn(
            r"(\w+_kernel<S[^>]*>)<<<grid, block, smem, stream>>>\(p\);",
            r"yt_emulate(grid, block, [&] { \1(p); });", header)
        assert (n_decl, n_launch) == (nk, nk), \
            f"the kernels' text in {fn} moved"
        (tmp_path / fn).write_text(header)
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-D__CUDACC__", "-D__CUDA_ARCH__=900",
                    "-Wno-unknown-pragmas", "-I", str(tmp_path), "-o",
                    str(so), str(src)]
                   + [f"-D{k}={v}" for k, v in (defines or {}).items()],
                   check=True, capture_output=True, timeout=300)
    entry = entry or spec.name
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = (
        fused_stencil.stages_stream_argtypes()
        if entry.endswith("_stages_stream") else
        fused_stencil.region_stages_stream_argtypes()
        if entry.endswith("_stages_stream_region") else
        fused_stencil.batched_stages_stream_argtypes()
        if entry.endswith("_stages_stream_batched") else
        fused_stencil.region_argtypes(spec.walks)
        if entry.endswith("_region") else
        fused_stencil.batched_argtypes(spec.walks)
        if entry.endswith("_batched") else
        fused_stencil.stream_argtypes() if entry.endswith("_stream") else
        fused_stencil.trap_batched_argtypes()
        if entry.endswith("_trap_batched") else
        fused_stencil.trapezoid_argtypes() if spec.trap else
        fused_stencil.entry_argtypes(spec.walks))
    fn.restype = ctypes.c_int
    return fn


def region_argtypes():
    """K5's C entry: K1's tables, the box table, the step, the stream."""
    return [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]


def rtm_ctx(radius, accumulate, cli=""):
    pipe = SolutionPipeline(
        yask_tpu_torch.yk_factory().new_env(device="cpu"),
        *rtm_chain(radius=radius, accumulate=accumulate))
    # ragged: two blocks in slot 0 (T0 = 8), three in slot 1, two in slot 2
    pipe.apply_command_line_options(
        f"-g_x 11 -g_y 19 -g_z 70 -mode fused -wf_steps 1 {cli}")
    pipe.prepare(fuse=True)
    return pipe.fused_ctx


def iso_ctx():
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="iso3dfd",
                           radius=2)
    ctx.apply_command_line_options("-g_x 11 -g_y 19 -g_z 70 -mode fused")
    ctx.prepare_solution()
    return ctx


@pytest.mark.parametrize("case", ["k6_pure_r2", "k6_accumulating_r2",
                                  "k6_pure_r8", "k1_iso3dfd_r2"])
def test_device_code_matches_plain_when_emulated(case, tmp_path):
    import torch
    ctx = {"k6_pure_r2": lambda: rtm_ctx(2, False),
           "k6_accumulating_r2": lambda: rtm_ctx(2, True),
           "k6_pure_r8": lambda: rtm_ctx(8, False),
           "k1_iso3dfd_r2": iso_ctx}[case]()
    import_interiors(ctx, seeded_interiors(ctx, 5))
    prog = ctx._program
    spec = ctx._fused_spec_kernel().spec
    if case == "k6_pure_r8":
        assert spec.tile == (2, 8, 64)      # the ladder stepped down
    fn = emulated_kernel(spec, tmp_path)
    state = ctx._state
    for t in (0, 1):
        ins = [state[n][s] for n, s in spec.inputs]
        outs = [torch.zeros(tuple(prog.geoms[n].shape), dtype=torch.float32)
                for n in spec.outputs]
        assert fused_stencil.call_entry(fn, prog, spec, ins, outs, t,
                                        None) == 0
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, a in zip(spec.outputs, outs):
            torch.testing.assert_close(a, want[n][-1], rtol=0, atol=0)
        state = want


# ---------------------------------------------------------------------------
# K4: phase 1 and the diamonds, threads and NaN-filled shared memory
# ---------------------------------------------------------------------------


def trap_ctx(stencil, radius, g, K):
    """A fused context on the CPU with its trapezoid request forced (as
    tests/test_trapezoid.py forces ``build_pallas_chunk(trapezoid=True)``):
    ``g`` (x, y, z) with every trapezoid dim at least three tile
    boundaries wide and a ragged minor dim."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil=stencil,
                           radius=radius)
    ctx._trapezoid_arg = lambda: True
    ctx.apply_command_line_options(
        f"-g_x {g[0]} -g_y {g[1]} -g_z {g[2]} -mode fused -wf_steps {K} "
        "-trapezoid -no-skew")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_interiors(ctx, 9))
    return ctx


def k4_group(fn, ctx, spec, t0, passes):
    """One K-step group through the emulated entry: the given passes into
    NaN-filled outputs, pads re-zeroed and rings rotated as
    ``trapezoid_chunk`` does."""
    import torch
    prog = ctx._program
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    for p in passes:
        assert fused_stencil.call_trapezoid_entry(fn, prog, spec, ins, outs,
                                                  p, t0, None) == 0
    for n, o in zip(spec.outputs, outs):
        fused_stencil._zero_pads(prog, n, o)
    return fused_stencil._rotated(prog, spec, state, outs)


def same(got, want):
    import torch
    return all(torch.equal(a, b) for n in want
               for a, b in zip(got[n], want[n]))


@pytest.mark.parametrize("stencil,radius,g,K", [
    ("iso3dfd", 2, (36, 36, 21), 4), ("iso3dfd", 2, (36, 36, 21), 3),
    ("cube", 1, (24, 24, 11), 4), ("iso3dfd_sponge", 2, (24, 24, 13), 2)])
def test_k4_device_code_matches_plain_when_emulated(stencil, radius, g, K,
                                                    tmp_path):
    ctx = trap_ctx(stencil, radius, g, K)
    trap = ctx._trapezoid_kernel()
    spec = trap.spec
    assert [d["nbounds"] >= 3 for d in spec.trap["diamond"]] == [True, True]
    fn = emulated_kernel(spec, tmp_path)
    got = k4_group(fn, ctx, spec, 0, range(len(spec.trap["passes"])))
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, K)
    assert same(got, want)


def test_k4_emulation_fails_without_a_diamond_pass(tmp_path):
    ctx = trap_ctx("iso3dfd", 2, (36, 36, 21), 4)
    spec = ctx._trapezoid_kernel().spec
    fn = emulated_kernel(spec, tmp_path)
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, 4)
    assert same(k4_group(fn, ctx, spec, 0, (0, 1, 2)), want)
    assert not same(k4_group(fn, ctx, spec, 0, (0, 1)), want)


def test_k4_emulation_fails_with_windows_one_level_deeper(tmp_path,
                                                          monkeypatch):
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops.tile_planner import TilePlan
    ctx = trap_ctx("iso3dfd", 2, (36, 36, 21), 4)
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, 4)
    shrink = TilePlan.write_shrink
    monkeypatch.setattr(TilePlan, "write_shrink",
                        lambda self, d, lvl: shrink(self, d, lvl + 1))
    spec = cuda_emit.resolve_trapezoid(ctx._program, 4, True)
    fn = emulated_kernel(spec, tmp_path)
    assert not same(k4_group(fn, ctx, spec, 0, (0, 1, 2)), want)


# ---------------------------------------------------------------------------
# K5: one shard's sub-steps over boxes reaching into the ghosts
# ---------------------------------------------------------------------------


def k5_shard():
    """A shard_pallas context on 4 CPU devices (iso3dfd r=2, K=3, shards
    of 11×9×70) and the shard at mesh position x=1, y=0: its box reaches
    past the global domain on the right in x and on the left in y."""
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * 4),
                           stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options(
        "-g_x 22 -g_y 18 -g_z 70 -mode shard_pallas -wf_steps 3 -nr_x 2 "
        "-nr_y 2")
    ctx.prepare_solution()
    sp = shard_pallas_plan(ctx)
    i = sp.layout.mesh.index({"x": 1, "y": 0, "z": 0})
    return sp.kernel, sp.layout.offsets[i]


@pytest.mark.parametrize("path", ["host", "device"])
def test_k5_matches_plain_shard_chunk(path, tmp_path):
    """Three sub-steps of one group, each box the interior grown by 4, 2,
    0 in x and y (negative lo), from random inputs over the whole padded
    arrays: the g++ host path and the emulated device code (NaN-filled
    shared memory) against ``plain_shard_chunk``, to the bit; cells
    outside the global domain come out zero."""
    import numpy as np
    import torch
    from test_torch_fused import host_kernel
    kern, off = k5_shard()
    prog, spec = kern.program, kern.spec
    assert off == {"x": 11, "y": 0, "z": 0}
    if path == "host":
        fn = host_kernel(spec, tmp_path, entry=spec.name + "_region")
        fn.argtypes = region_argtypes()
    else:
        fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_region")
    rng = np.random.RandomState(5)
    state = {n: [torch.tensor(rng.rand(*g.shape).astype(np.float32))
                 for _ in range(g.num_slots)]
             for n, g in prog.geoms.items()}
    got = want = state
    shifted = fused_stencil._with_offset(prog, off, torch.device("cpu"))
    for s, e in enumerate((4, 2, 0)):
        box = {"x": (-e, 11 + e), "y": (-e, 9 + e), "z": (0, 70)}
        fused_stencil.check_box(prog, spec, box)
        ins = [got[n][k] for n, k in spec.inputs]
        outs = [torch.zeros(tuple(prog.geoms[n].shape))
                for n in spec.outputs]
        assert fused_stencil.call_region_entry(fn, prog, spec, ins, outs,
                                               box, off, s, None) == 0
        got = fused_stencil._rotated(prog, spec, got, outs)
        want = fused_stencil.plain_shard_chunk(shifted, want, s, box)
        assert same(got, want)
    p = got["pressure"][-1]
    g = prog.geoms["pressure"]
    ox, oy, oz = g.origin["x"], g.origin["y"], g.origin["z"]
    assert not p[ox + 11:].any() and not p[:, :oy].any()   # x ≥ 22, y < 0
    assert p[ox:ox + 11, oy:oy + 9, oz:oz + 70].abs().min() > 0


def test_k5_box_check_refuses_reads_past_the_pads():
    kern, _off = k5_shard()
    with pytest.raises(YaskException, match="passes its pads"):
        fused_stencil.check_box(kern.program, kern.spec,
                                {"x": (-7, 11), "y": (0, 9), "z": (0, 70)})
    with pytest.raises(YaskException, match="empty box"):
        fused_stencil.check_box(kern.program, kern.spec,
                                {"x": (3, 3), "y": (0, 9), "z": (0, 70)})


# ---------------------------------------------------------------------------
# K1's stream arm: a ring of planes per staged input, cp.async deferred
# ---------------------------------------------------------------------------


def stream_ctx(stencil, radius, g):
    """A fused context on the CPU with ``-skew`` (the stream arm engaged)
    at ``g`` = (x, y, z), seeded."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil=stencil,
                           radius=radius)
    ctx.apply_command_line_options(
        f"-g_x {g[0]} -g_y {g[1]} -g_z {g[2]} -mode fused -skew")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_interiors(ctx, 7))
    assert ctx._fused_spec_kernel().skew_dims == ["x"]
    return ctx


def stream_steps(fn, ctx, spec, seg, steps):
    """``steps`` sub-steps through the emulated stream entry, each into
    NaN-filled outputs, rings rotated as ``stream_step`` does."""
    import torch
    prog = ctx._program
    state = ctx._state
    for t in range(steps):
        ins = [state[n][s] for n, s in spec.inputs]
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
                for n in spec.outputs]
        assert fused_stencil.call_stream_entry(fn, prog, spec, ins, outs, t,
                                               None, seg=seg) == 0
        state = fused_stencil._rotated(prog, spec, state, outs)
    return state


@pytest.mark.parametrize("stencil,radius,g,seg", [
    ("iso3dfd", 8, (67, 45, 131), 67),   # ragged plane tiles, one segment
    ("iso3dfd", 2, (67, 45, 131), 40),   # a segment boundary at x = 40
    ("cube", 1, (13, 20, 70), 5)])       # off-axis reads, three segments
def test_stream_device_code_matches_plain_when_emulated(stencil, radius, g,
                                                        seg, tmp_path):
    """The stream arm's device code (threads, NaN-filled shared memory,
    each cp.async leaving its destination NaN until its wait, NaN-filled
    outputs) against ``plain_chunk`` over two sub-steps, to the bit: every
    interior cell computed from the right planes, every pad cell 0."""
    ctx = stream_ctx(stencil, radius, g)
    spec = ctx._fused_spec_kernel().spec
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stream")
    got = stream_steps(fn, ctx, spec, seg, 2)
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, 2)
    assert same(got, want)


def test_stream_device_code_walks_its_grid_in_chunks_when_emulated(
        tmp_path):
    """ROADMAP.md C15: the launch code walks the stream arm's y and z
    blocks ``YT_MAX_GRID_Z`` at a time (here 2: 3 segments x 2 row
    blocks in four launches), the pads shared out over the whole grid:
    the same bits as ``plain_chunk`` over two sub-steps."""
    ctx = stream_ctx("cube", 1, (13, 20, 70))
    spec = ctx._fused_spec_kernel().spec
    assert -(-20 // spec.stream.tile[0]) == 2
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stream",
                         defines={"YT_MAX_GRID_Z": 2})
    got = stream_steps(fn, ctx, spec, 5, 2)
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, 2)
    assert same(got, want)


def test_stream_emulation_fails_with_a_ring_one_plane_short(tmp_path,
                                                            monkeypatch):
    """A ring of h0_lo + h0_hi + 1 + P planes lets the prefetch of output
    plane z land in the oldest plane output plane z - 1 reads, which the
    one barrier per plane does not keep apart."""
    from yask_tpu_torch.ops import cuda_emit, tile_planner
    ctx = stream_ctx("iso3dfd", 2, (13, 19, 70))
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, 1)
    depth = tile_planner.ring_depth
    monkeypatch.setattr(tile_planner, "ring_depth",
                        lambda lo, hi, pf: depth(lo, hi, pf) - 1)
    spec = cuda_emit.emit(ctx._program)
    assert spec.stream.depths == {spec.tiled[0]: 7}
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stream")
    assert not same(stream_steps(fn, ctx, spec, 13, 1), want)


def test_stream_emulation_fails_without_the_wait(tmp_path):
    """Computing a plane before cp.async.wait_group reads planes still in
    flight."""
    import re as _re
    ctx = stream_ctx("iso3dfd", 2, (13, 19, 70))
    spec = ctx._fused_spec_kernel().spec
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, 1)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stream")
    assert same(stream_steps(fn, ctx, spec, 13, 1), want)

    def drop_wait(name, text):
        if name != "stream_step.cuh":
            return text
        text, n = _re.subn(r"\n\s*cp_async_wait<S::SP>\(\);", "", text)
        assert n == 1
        return text
    (tmp_path / "nowait").mkdir()
    fn = emulated_kernel(spec, tmp_path / "nowait", entry=spec.name
                         + "_stream", edit=drop_wait)
    assert not same(stream_steps(fn, ctx, spec, 13, 1), want)
