"""The port's in-process server (``yask_tpu_torch/serve/``): batching,
degradation, quarantine, bucketing, streaming, the resident path, and
the journal's rows against ``yask_tpu``'s.

Everything runs on the CPU at iso3dfd r=2, g=16, 3 sessions: a fused
session runs K7's plain version there.  Results are held bit-identical to
solo port contexts (the same code on the same data); the journal is held
to ``yask_tpu``'s event names and detail keys for the same request
sequence.  Faults are injected with ``YT_FAULT_PLAN``.
"""

import os

import numpy as np
import pytest

import yask_tpu
import yask_tpu.serve
import yask_tpu_torch
from yask_tpu_torch.obs import tracer
from yask_tpu_torch.obs.metrics import Registry, percentile
from yask_tpu_torch.obs.slo import SloMonitor
from yask_tpu_torch.resilience import checkpoint, faults, sanity
from yask_tpu_torch.resilience.faults import reset_faults
from yask_tpu_torch.runtime.init_utils import init_solution_vars
from yask_tpu_torch.serve import (ServeJournal, ServeRequest, StencilServer,
                                  default_serve_journal_path)
from yask_tpu_torch.serve.resident import run_per_request
from yask_tpu_torch.serve.scheduler import extract_outputs
from yask_tpu_torch.utils.exceptions import YaskException

G = 16
STEPS = 4   # two wf=2 chunks
N = 3


@pytest.fixture(autouse=True)
def _clean_fault_plan(monkeypatch):
    monkeypatch.delenv("YT_FAULT_PLAN", raising=False)
    reset_faults()
    yield
    reset_faults()


@pytest.fixture(scope="module")
def env():
    return yask_tpu_torch.yk_factory().new_env(device="cpu")


def mk_server(env, tmp_path, **kw):
    kw.setdefault("window_secs", 0.05)
    kw.setdefault("max_batch", 16)
    return StencilServer(env, journal_path=str(tmp_path / "SERVE.jsonl"),
                         **kw)


@pytest.fixture()
def server(env, tmp_path):
    srv = mk_server(env, tmp_path)
    yield srv
    srv.shutdown()


def seed(ctx, i, g=G):
    ctx.get_var("vel").set_all_elements_same(0.5)
    rng = np.random.RandomState(100 + i)
    arr = (rng.rand(g, g, g).astype(np.float32) - 0.5) * 0.1
    ctx.get_var("pressure").set_elements_in_slice(
        arr, [0, 0, 0, 0], [0, g - 1, g - 1, g - 1])


def open_and_seed(srv, i, mode="fused", g=G):
    sid = srv.open_session(stencil="iso3dfd", radius=2, g=g, mode=mode,
                           wf=2, bucket=False)
    with srv.scheduler.session_ctx(sid) as ctx:
        seed(ctx, i, g)
    return sid


def solo(env, mode, first=0, last=STEPS - 1, i=None, g=G):
    """A lone port context: ``seed(i)`` when ``i`` is given, else the
    standard ``init_solution_vars``."""
    ctx = yask_tpu_torch.yk_factory().new_solution(env, stencil="iso3dfd",
                                                   radius=2)
    ctx.apply_command_line_options(f"-g {g} -mode {mode} -wf_steps 2")
    ctx.prepare_solution()
    if i is None:
        init_solution_vars(ctx)
    else:
        seed(ctx, i, g)
    ctx.run_solution(first, last)
    return extract_outputs(ctx)


def assert_same(got, want, label=""):
    assert set(got) == set(want), label
    for name, a in want.items():
        assert got[name].shape == a.shape, (label, name)
        assert np.array_equal(got[name], a), (label, name)


# ------------------------------------------------------------- batching

@pytest.mark.parametrize("mode", ["fused", "torch"])
def test_occupancy_3_batching_bit_identical_to_solo(server, env, mode):
    sids = [open_and_seed(server, i, mode) for i in range(N)]
    resps = [server.wait(h, timeout=120) for h in
             [server.submit_run(sid, 0, STEPS - 1) for sid in sids]]
    for i, r in enumerate(resps):
        assert r.ok, (r.status, r.error)
        assert r.batch == N and not r.degraded and r.mode == mode
        # fused members ride one batched program (K7); torch-mode members
        # run one after another in the same turn
        assert r.batched == (mode == "fused")
        assert_same(r.outputs, solo(env, mode, i=i), f"{mode} #{i}")
    assert server.journal.max_occupancy() == N
    m = server.metrics()
    assert m["completed"] == N and m["ok"] == N
    assert m["batch_occupancy_max"] == N and m["profiles"] == 1


def test_same_session_requests_serialize_in_order(server, env):
    sid = open_and_seed(server, 0)
    h1 = server.submit_run(sid, 0, 1)
    h2 = server.submit_run(sid, 2, STEPS - 1)
    r1, r2 = server.wait(h1, timeout=120), server.wait(h2, timeout=120)
    assert r1.ok and r2.ok and r1.batch == 1 and r2.batch == 1
    assert_same(r2.outputs, solo(env, "fused", i=0))


def test_prewarm_touches_the_fused_kernel_only(server):
    assert server.prewarm(open_and_seed(server, 0, "fused"), STEPS) == 1
    assert server.prewarm(open_and_seed(server, 1, "torch"), STEPS) == 0


def test_unknown_session_and_missing_output_rejected(server):
    r = server.request(ServeRequest(session="nope", first_step=0),
                       timeout=60)
    assert r.status == "rejected" and "unknown" in r.error
    sid = open_and_seed(server, 0)
    r = server.run(sid, 0, 1, outputs=("no_such_var",), timeout=60)
    assert r.status == "rejected" and "no_such_var" in r.error
    r = server.run(sid, 2, 3, outputs=("pressure",), timeout=60)
    assert r.ok and set(r.outputs) == {"pressure"}


# ------------------------------------------------------- fault handling

def test_fault_degrades_fused_session_to_torch(env, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("YT_FAULT_PLAN", "serve.run:device_hang:1")
    reset_faults()
    srv = mk_server(env, tmp_path, window_secs=0.0)
    try:
        sid = open_and_seed(srv, 0, "fused")
        r = srv.run(sid, 0, STEPS - 1, timeout=120)
        assert r.ok, (r.status, r.error)
        assert r.degraded and r.mode == "torch"
        assert srv.session_mode(sid) == "torch"
        events = [e["event"] for e in srv.journal.events(r.rid)]
        assert events == ["received", "batched", "fault", "degraded", "ok"]
        row = [e for e in srv.journal.events(r.rid)
               if e["event"] == "degraded"][0]
        assert row["detail"]["to_mode"] == "torch"
        assert row["detail"]["ladder_path"] == ["torch"]
        assert_same(r.outputs, solo(env, "torch", i=0))
    finally:
        srv.shutdown()


@pytest.mark.parametrize("kind", ["device_hang", "compile_failed",
                                  "compiler_oom"])
def test_fault_on_card_rejects_fused_session(env, tmp_path, monkeypatch,
                                             kind):
    """A session whose tensors lie on the card never steps down to the
    plain version: the fault rejects the request with its kind."""
    from yask_tpu_torch.runtime.context import StencilContext
    monkeypatch.setattr(StencilContext, "is_offloaded", lambda self: True)
    monkeypatch.setenv("YT_FAULT_PLAN", f"serve.run:{kind}:1")
    reset_faults()
    srv = mk_server(env, tmp_path, window_secs=0.0)
    try:
        sid = open_and_seed(srv, 0, "fused")
        r = srv.run(sid, 0, STEPS - 1, timeout=120)
        assert r.status == "rejected" and kind in r.error
        assert not r.outputs
        assert srv.session_mode(sid) == "fused"
        rows = srv.journal.events(r.rid)
        assert [e["event"] for e in rows] == ["received", "batched",
                                              "fault", "rejected"]
        assert rows[2]["detail"]["kind"] == kind
        assert srv.metrics()["degraded"] == 0
    finally:
        srv.shutdown()


def test_deadline_spent_in_queue_rejects_before_the_device(env, tmp_path):
    srv = mk_server(env, tmp_path, window_secs=0.3)
    try:
        sid = open_and_seed(srv, 0)
        r = srv.request(ServeRequest(session=sid, first_step=0,
                                     last_step=1, deadline_secs=0.05),
                        timeout=60)
        assert r.status == "rejected" and "in queue" in r.error
        rows = srv.journal.events(r.rid)
        assert [e["event"] for e in rows] == ["received", "rejected"]
        assert rows[-1]["detail"]["reason"] == "deadline_in_queue"
        with srv.scheduler.session_ctx(sid) as ctx:
            assert ctx._steps_done == 0
    finally:
        srv.shutdown()


def test_exhausted_ladder_rejects(env, tmp_path, monkeypatch):
    monkeypatch.setenv("YT_FAULT_PLAN", "serve.run:device_hang:99")
    reset_faults()
    srv = mk_server(env, tmp_path, window_secs=0.0)
    try:
        sid = open_and_seed(srv, 0, "fused")
        r = srv.run(sid, 0, STEPS - 1, timeout=120)
        assert r.status == "rejected" and "device_hang" in r.error
        assert "exhausted" in r.error
        assert srv.journal.terminal(r.rid) == "rejected"
        # a third consecutive fault trips the shared breaker: no ladder
        sid2 = open_and_seed(srv, 1, "fused")
        r2 = srv.run(sid2, 0, 1, timeout=120)
        assert r2.status == "rejected" and "breaker" in r2.error
    finally:
        srv.shutdown()
    # torch is the floor: a torch session has no rung to walk to
    srv = mk_server(env, tmp_path, window_secs=0.0)
    try:
        sid = open_and_seed(srv, 0, "torch")
        r = srv.run(sid, 0, 1, timeout=120)
        assert r.status == "rejected" and "exhausted" in r.error
    finally:
        srv.shutdown()


def test_corrupt_output_quarantined_as_anomaly(env, tmp_path, monkeypatch):
    monkeypatch.setenv("YT_FAULT_PLAN", "serve.respond:zero_output:1")
    reset_faults()
    srv = mk_server(env, tmp_path, window_secs=0.0)
    try:
        sid = open_and_seed(srv, 0)
        r = srv.run(sid, 0, STEPS - 1, timeout=120)
        assert r.status == "anomaly" and not r.ok
        assert "all_zero" in r.anomaly["anomalies"]
        assert float(np.abs(r.outputs["pressure"]).max()) == 0.0
        assert srv.journal.terminal(r.rid) == "anomaly"
        assert srv.metrics()["anomalies"] == 1
    finally:
        srv.shutdown()


def test_unclassified_launch_failure_rejects(env, tmp_path, monkeypatch):
    """A kernel launch that fails is not a classified fault: the request
    is rejected; nothing degrades it or reruns it another way."""
    from yask_tpu_torch.ops import fused_stencil

    def broken(*_a, **_k):
        raise YaskException("batched_step kernel 'k_batched' launch "
                            "failed: CUDA error 700")
    monkeypatch.setattr(fused_stencil.FusedKernel, "batched_chunk", broken)
    srv = mk_server(env, tmp_path)
    try:
        sids = [open_and_seed(srv, i) for i in range(2)]
        resps = [srv.wait(h, timeout=120) for h in
                 [srv.submit_run(s, 0, 1) for s in sids]]
        assert all(r.status == "rejected" and "launch failed" in r.error
                   for r in resps)
        assert all(srv.session_mode(s) == "fused" for s in sids)
    finally:
        srv.shutdown()


# -------------------------------------------------------------- buckets

def test_bucketed_mixed_geometries_bit_identical(env, tmp_path):
    srv = mk_server(env, tmp_path)
    try:
        gs = (10, 12, 16)
        sids = []
        for g in gs:
            sid = srv.open_session(stencil="iso3dfd", radius=2, g=g,
                                   mode="torch", wf=2, bucket=True)
            b = srv.session_bucket(sid)
            assert b["decision"] == "bucketed" and b["bucket"] == 16, b
            srv.init_vars(sid)
            sids.append(sid)
        resps = [srv.wait(h, timeout=120) for h in
                 [srv.submit_run(s, 0, STEPS - 1) for s in sids]]
        assert all(r.ok for r in resps), [(r.status, r.error)
                                          for r in resps]
        assert max(r.batch for r in resps) == len(gs)
        for g, r in zip(gs, resps):
            assert_same(r.outputs, solo(env, "torch", g=g), f"g={g}")
        rows = ServeJournal(str(tmp_path / "SERVE.jsonl")).rows()
        assert any(r["event"] == "batched"
                   and r["detail"]["bucket"]["decision"] == "bucketed"
                   for r in rows)
    finally:
        srv.shutdown()


def test_fused_session_declines_bucketing_and_serves_exact(env, tmp_path):
    srv = mk_server(env, tmp_path)
    try:
        sid = srv.open_session(stencil="iso3dfd", radius=2, g=12,
                               mode="fused", wf=2, bucket=True)
        b = srv.session_bucket(sid)
        assert b["decision"] == "declined" and "torch" in b["reason"]
        srv.init_vars(sid)
        r = srv.run(sid, 0, STEPS - 1, timeout=120)
        assert r.ok
        assert_same(r.outputs, solo(env, "fused", g=12))
    finally:
        srv.shutdown()


# -------------------------------------------------- streaming, preemption

def test_streaming_flush_and_preemption_bit_identity(env, tmp_path):
    srv = mk_server(env, tmp_path)
    try:
        long_sid = open_and_seed(srv, 0)
        short_sid = open_and_seed(srv, 1, g=10)
        seen = []
        h_long = srv.submit(
            ServeRequest(session=long_sid, first_step=0, last_step=7,
                         flush_every=2, stream_outputs=True),
            on_stream=seen.append)
        h_short = srv.submit_run(short_sid, 0, 0)
        r_long = srv.wait(h_long, timeout=120)
        r_short = srv.wait(h_short, timeout=120)
        assert r_long.ok and r_short.ok
        assert r_long.preempted >= 1, "long run never yielded"
        assert [ev["step"] for ev in r_long.streams] == [1, 3, 5]
        assert [ev["step"] for ev in seen] == [1, 3, 5]
        assert_same(r_long.outputs, solo(env, "fused", 0, 7, i=0))
        assert_same(r_long.streams[1]["outputs"],
                    solo(env, "fused", 0, 3, i=0))
        events = {r["event"] for r in srv.journal.rows()}
        assert {"stream", "preempted"} <= events
    finally:
        srv.shutdown()


def test_flush_fault_is_nonfatal(env, tmp_path, monkeypatch):
    monkeypatch.setenv("YT_FAULT_PLAN", "serve.flush:relay_down:1")
    reset_faults()
    srv = mk_server(env, tmp_path)
    try:
        sid = open_and_seed(srv, 0)
        r = srv.run(sid, 0, 7, flush_every=2, timeout=120)
        assert r.ok, (r.status, r.error)
        assert len(r.streams) == 2
        rows = [x for x in srv.journal.rows() if x["event"] == "fault"]
        assert rows and rows[0]["detail"]["site"] == "serve.flush"
        assert rows[0]["detail"]["nonfatal"] is True
    finally:
        srv.shutdown()


# ------------------------------------------------------------- resident

def test_run_resident_bit_identical_to_per_request(server, env):
    sids_r = [open_and_seed(server, i) for i in range(N)]
    sids_p = [open_and_seed(server, i) for i in range(N)]

    def work(sids):
        return [(sid, t, t) for t in range(STEPS) for sid in sids]
    res = server.scheduler.run_resident(work(sids_r))
    base = run_per_request(server.scheduler, work(sids_p), timeout=120)
    for i, (sr, sp) in enumerate(zip(sids_r, sids_p)):
        assert res[sr]["items"] == STEPS
        assert_same(res[sr]["outputs"], base[sp]["outputs"], f"#{i}")
        assert_same(res[sr]["outputs"], solo(env, "fused", i=i), f"#{i}")
    events = [r["event"] for r in server.journal.rows()]
    assert "resident_queue" in events and "resident_done" in events
    with pytest.raises(YaskException, match="unknown"):
        server.scheduler.run_resident([("nope", 0, 0)])


# -------------------------------------------------- journal vs yask_tpu

def _journal_shape(rows):
    """Per request, its events with their detail keys (values such as
    the mode name differ between the packages)."""
    out = {}
    for r in rows:
        out.setdefault(r["rid"], []).append(
            (r["event"], tuple(sorted(r.get("detail", {})))))
    return out


def test_journal_rows_match_yask_tpu(env, tmp_path):
    """The same request sequence through both servers (port torch mode,
    yask_tpu jit mode): two co-batched requests, then a streamed one,
    then an unknown session."""
    def drive(srv, mode):
        sids = [srv.open_session(stencil="iso3dfd", radius=2, g=G,
                                 mode=mode, wf=2, bucket=False)
                for _ in range(2)]
        for sid in sids:
            srv.init_vars(sid)
        hs = [srv.submit_run(s, 0, 1) for s in sids]
        assert all(srv.wait(h, timeout=300).ok for h in hs)
        assert srv.run(sids[0], 2, 7, flush_every=3, timeout=300).ok
        srv.request(ServeRequest(session="nope", first_step=0),
                    timeout=60)
        return srv.journal.rows()

    mine = StencilServer(env, journal_path=str(tmp_path / "port.jsonl"),
                         window_secs=0.05)
    try:
        port_rows = drive(mine, "torch")
    finally:
        mine.shutdown()
    theirs = yask_tpu.serve.StencilServer(
        journal_path=str(tmp_path / "tpu.jsonl"), window_secs=0.05,
        preflight=False)
    try:
        tpu_rows = drive(theirs, "jit")
    finally:
        theirs.shutdown()
    assert _journal_shape(port_rows) == _journal_shape(tpu_rows)
    assert {r["v"] for r in port_rows} == {"yask_tpu.serve/1"}


# ------------------------------------------- what the port does not carry

def test_server_refuses_what_is_not_ported(env, tmp_path):
    with pytest.raises(YaskException, match="A14"):
        StencilServer(env, journal_path=str(tmp_path / "j.jsonl"),
                      preflight=True)
    srv = mk_server(env, tmp_path)
    try:
        with pytest.raises(YaskException, match="A14"):
            srv.flush_metrics()
        with pytest.raises(YaskException, match="A7.*A13"):
            srv.metrics_snapshot()
    finally:
        srv.shutdown()
    with pytest.raises(YaskException, match="A14"):
        with tracer.profile_window("/nonexistent"):
            pass


def test_default_paths_stay_out_of_tracked_files(monkeypatch, tmp_path):
    for var in ("YT_SERVE_JOURNAL", "YT_TRACE_EVENTS", "YT_BREAKER_STATE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("YT_TORCH_STATE_DIR", str(tmp_path / "state"))
    for p in (default_serve_journal_path(), tracer.default_trace_path(),
              faults.default_breaker_path()):
        assert os.path.dirname(p) == str(tmp_path / "state")
    monkeypatch.delenv("YT_TORCH_STATE_DIR")
    pkg = os.path.dirname(os.path.abspath(yask_tpu_torch.__file__))
    build = os.path.join(pkg, "build") + os.sep
    for p in (default_serve_journal_path(), tracer.default_trace_path(),
              faults.default_breaker_path()):
        assert p.startswith(build), p


# ------------------------------------------- resilience and obs pieces

def test_classify_cuda_signatures():
    import torch
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert isinstance(faults.classify(oom), faults.CompilerOOM)
    build = YaskException("kernel build failed:\nk: nvcc exit 1\nerror")
    assert isinstance(faults.classify(build), faults.CompileFailed)
    assert isinstance(faults.classify(YaskException("nvcc not found (PATH)")),
                      faults.CompileFailed)
    # Mosaic's signatures are not the port's
    assert faults.classify(RuntimeError("Mosaic failed to compile")) is None
    assert faults.classify(KeyError("x")) is None
    b = faults.Breaker(threshold=2)
    assert not b.record(faults.DeviceHang("h"))
    assert b.record(faults.DeviceHang("h"))
    b.reset()
    assert not b.tripped


def test_guarded_call_classifies_and_retries(monkeypatch):
    from yask_tpu_torch.resilience.guard import guarded_call
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("Connection reset by peer")
        return 7
    assert guarded_call(flaky, site="serve.run", retries=2,
                        backoff=0.0) == 7
    monkeypatch.setenv("YT_FAULT_PLAN", "serve.run:compile_failed:1")
    reset_faults()
    with pytest.raises(faults.CompileFailed):
        guarded_call(lambda: 1, site="serve.run")
    with pytest.raises(ValueError):
        guarded_call(lambda: (_ for _ in ()).throw(ValueError("bug")),
                     site="serve.run")


def test_snapshot_restores_across_modes_bit_identically(env, tmp_path):
    def mk(mode):
        ctx = yask_tpu_torch.yk_factory().new_solution(
            env, stencil="iso3dfd", radius=2)
        ctx.apply_command_line_options(f"-g {G} -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        return ctx
    a = mk("fused")
    seed(a, 3)
    a.run_solution(0, 1)
    snap = checkpoint.extract_snapshot(a)
    path = checkpoint.save_checkpoint(a, str(tmp_path / "c.npz"))
    assert checkpoint.peek_checkpoint(path)["cur_step"] == 2
    b, c = mk("torch"), mk("ref")
    assert checkpoint.apply_snapshot(b, snap)
    assert checkpoint.restore_checkpoint(c, path)
    assert not checkpoint.restore_checkpoint(c, str(tmp_path / "none"))
    for ctx in (a, b, c):
        ctx.run_solution(2, 3)
    assert_same(extract_outputs(b), extract_outputs(a))
    assert c.compare_data(a) == 0
    assert checkpoint.degradation_ladder("fused") == ["torch"]
    assert checkpoint.degradation_ladder("fused", on_card=True) == []
    assert checkpoint.degradation_ladder("torch") == []


def test_sanity_verdicts():
    assert sanity.check_output({"p": np.ones(8)})["ok"]
    v = sanity.check_output({"p": np.zeros(8)})
    assert not v["ok"] and v["anomalies"] == ["all_zero"]
    v = sanity.check_output([np.array([1.0, np.nan])])
    assert "nonfinite" in v["anomalies"]
    assert sanity.anomaly_fields(v)["quarantined"] is True
    import torch
    assert sanity.check_output({"p": torch.ones(4)})["ok"]


def test_tracer_spans_only_when_enabled(monkeypatch, tmp_path):
    path = tmp_path / "trace.jsonl"
    monkeypatch.setenv("YT_TRACE_EVENTS", str(path))
    monkeypatch.delenv("YT_TRACE", raising=False)
    with tracer.span("serve.chunk", phase="compute"):
        pass
    assert not path.exists()
    monkeypatch.setenv("YT_TRACE", "1")
    with tracer.activate("tabc"):
        with tracer.span("serve.chunk", phase="compute", batch=3):
            with tracer.span("ensemble.run", phase="compute"):
                pass
        assert tracer.stamp_trace({})["trace_id"] == "tabc"
    tracer.record_span("serve.queue_wait", "queue", 0.0, 0.01,
                       trace="tabc")
    rows = tracer.read_spans(str(path))
    assert [r["name"] for r in rows] == ["ensemble.run", "serve.chunk",
                                         "serve.queue_wait"]
    assert rows[0]["parent"] == rows[1]["span"]
    assert {r["trace"] for r in rows} == {"tabc"}
    assert tracer.phase_for_site("serve.flush") == "front"


def test_metrics_and_slo_monitor():
    reg = Registry()
    reg.counter("serve.requests.ok").inc(2)
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.histogram("serve.total_ms").observe(v)
    snap = reg.snapshot()
    assert snap["counters"]["serve.requests.ok"] == 2
    assert snap["histograms"]["serve.total_ms"]["p50"] == 3.0
    assert percentile([], 0.5) == 0.0
    assert SloMonitor.from_env({}) is None
    clock = [1000.0]
    mon = SloMonitor(windows=(60.0,), p99_ms=10.0, cooldown_secs=0.0,
                     clock=lambda: clock[0])
    for _ in range(5):
        mon.record(ok=True, total_ms=50.0, trace="tslow")
    br = mon.evaluate()
    assert [b["signal"] for b in br] == ["latency"]
    assert br[0]["trace"] == "tslow"
