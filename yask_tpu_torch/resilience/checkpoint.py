"""Portable, atomic solution checkpoints + the mode-degradation ladder.

Counterpart of ``yask_tpu/resilience/checkpoint.py``, with the same
schema (``yask_tpu.checkpoint/1``): a snapshot of the FULL ring state of
a prepared solution, saved by INTERIOR coordinates.  Physical-boundary
ghost cells are zero in every mode, so a snapshot taken under one
mode/padding restores bit-identically into any other — which is what
lets the server walk a faulted CPU session down the degradation ladder
(``fused`` → ``torch``, ``shard_pallas`` → ``shard_map`` → ``torch``)
from its last committed state; a shard-mode context is gathered first
(``_materialize_state``), so a snapshot taken under ``torch`` restores
under ``shard_pallas`` and the reverse.

* in memory: :func:`extract_snapshot` / :func:`apply_snapshot` (the
  serving scheduler's rollback target);
* on disk: :func:`save_checkpoint` / :func:`restore_checkpoint` — an
  atomic ``.npz`` (tmp file + ``os.replace``); ``restore`` returns
  ``False`` on ANY problem, never raises.

Supervised runs (``ckpt_every``, the watchdog) are not ported yet
(ROADMAP.md A10).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from yask_tpu_torch.compiler.lowering import dtype_name, host_dtype
from yask_tpu_torch.resilience.faults import fault_point
from yask_tpu_torch.runtime.var import _to_numpy

__all__ = [
    "CKPT_SCHEMA", "extract_snapshot", "apply_snapshot",
    "save_checkpoint", "restore_checkpoint", "peek_checkpoint",
    "degradation_ladder",
]

CKPT_SCHEMA = "yask_tpu.checkpoint/1"

#: On a classified fault, retry the run under a simpler mode: the
#: distributed-fused path first sheds K5, then the mesh; the single-device
#: fused path sheds its kernel.  ``torch`` is the floor (and ``ref`` is an
#: oracle, not a production mode — it never degrades).
_LADDER = {
    "shard_pallas": ("shard_map", "torch"),
    "shard_map": ("torch",),
    "sharded": ("torch",),
    "fused": ("torch",),
}


def degradation_ladder(mode: str, on_card: bool = False) -> List[str]:
    """Fallback modes to try, in order, when ``mode`` faults mid-run.

    A session whose tensors lie on the card has no ladder: a fused
    kernel that fails to build or launch there is a fault to report,
    never a cue to answer with the plain PyTorch version (ROADMAP.md
    §C3).  On the CPU the fused modes already run their plain versions,
    so stepping down changes no kernel."""
    if on_card:
        return []
    return list(_LADDER.get(mode, ()))


def _interior_index(g, gsz):
    """Index tuple selecting the interior of one padded slot array
    (domain axes clipped to the global sizes, misc/step axes whole) —
    the same geometry walk ``compare_data`` and the trace dumps use."""
    return tuple(
        slice(g.origin[dn], g.origin[dn] + gsz[dn])
        if kind == "domain" else slice(None)
        for dn, kind in g.axes)


def extract_snapshot(ctx) -> Dict:
    """Host-side snapshot of ``ctx``'s full ring state by interior
    coordinates: ``{"meta": {...}, "state": {var: [slot, ...]}}``.
    The context must be prepared; tensors are copied to the host."""
    ctx._check_prepared()
    ctx._materialize_state()
    gsz = ctx._opts.global_domain_sizes
    meta = {
        "schema": CKPT_SCHEMA,
        "solution": ctx.get_name(),
        "dtype": dtype_name(ctx._program.dtype),
        "domain": {d: int(gsz[d]) for d in ctx.get_domain_dim_names()},
        "rings": {},
        "axes": {},
        "cur_step": int(ctx._cur_step),
        "steps_done": int(ctx._steps_done),
    }
    state = {}
    for name, ring in ctx._state.items():
        g = ctx._program.geoms[name]
        idx = _interior_index(g, gsz)
        meta["rings"][name] = len(ring)
        meta["axes"][name] = [dn for dn, _ in g.axes]
        state[name] = [np.ascontiguousarray(_to_numpy(a[idx]))
                       for a in ring]
    return {"meta": meta, "state": state}


def apply_snapshot(ctx, snap: Dict) -> bool:
    """Restore a snapshot into a prepared context — possibly one with a
    DIFFERENT mode/padding than the snapshot was taken under.  Each
    slot is rebuilt as a zero padded array (the ghost-zero invariant)
    with the snapshot interior set against the context's CURRENT
    geometry, then pushed to the context's device through the normal
    path.  Returns ``False`` — never raises — on any
    identity mismatch (schema, solution, dtype, domain sizes, ring
    depths, axis order): the caller's fallback is a fresh run."""
    try:
        meta, state = snap["meta"], snap["state"]
        if meta.get("schema") != CKPT_SCHEMA:
            return False
        ctx._check_prepared()
        if meta.get("solution") != ctx.get_name():
            return False
        dtype = ctx._program.dtype
        if meta.get("dtype") != dtype_name(dtype):
            return False
        gsz = ctx._opts.global_domain_sizes
        dom = meta.get("domain", {})
        for d in ctx.get_domain_dim_names():
            if int(dom.get(d, -1)) != int(gsz[d]):
                return False
        ctx._materialize_state()
        rings = meta.get("rings", {})
        if set(rings) != set(ctx._state):
            return False
        new_state = {}
        for name, ring in ctx._state.items():
            g = ctx._program.geoms[name]
            if int(rings[name]) != len(ring):
                return False
            if meta.get("axes", {}).get(name) != [dn for dn, _ in g.axes]:
                return False
            idx = _interior_index(g, gsz)
            slots = []
            for i in range(len(ring)):
                a = np.asarray(state[name][i])
                dst = np.zeros(tuple(g.shape), dtype=host_dtype(dtype))
                if a.shape != dst[idx].shape:
                    return False
                dst[idx] = a
                slots.append(dst)
            new_state[name] = slots
    except Exception:  # noqa: BLE001 - any malformed snapshot → False
        return False
    ctx._state = new_state
    ctx._state_on_device = False
    if ctx._mode != "ref":
        ctx._state_to_device()
    ctx._cur_step = int(meta.get("cur_step", 0))
    ctx._steps_done = int(meta.get("steps_done", 0))
    return True


def save_checkpoint(ctx, path: str) -> str:
    """Atomically write ``ctx``'s snapshot to ``path``.  The npz is
    written to ``path + ".tmp"`` through an open file object (so numpy
    cannot append ``.npz`` and break atomicity) and renamed into place.
    Fault site ``ckpt.save``; span ``ckpt.save`` (phase
    ``checkpoint``)."""
    from yask_tpu_torch.obs.tracer import span
    with span("ckpt.save", phase="checkpoint", path=path) as sp:
        fault_point("ckpt.save")
        snap = extract_snapshot(ctx)
        payload = {"__meta__": np.frombuffer(
            json.dumps(snap["meta"], sort_keys=True).encode(),
            dtype=np.uint8)}
        for name, ring in snap["state"].items():
            for i, a in enumerate(ring):
                payload[f"{name}__slot{i}"] = a
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        sp.set(step=int(snap["meta"].get("cur_step", 0)),
               nvars=len(snap["state"]))
    return path


def peek_checkpoint(path: str) -> Optional[Dict]:
    """Read just the meta header of a checkpoint file; ``None`` when the
    file is missing, unreadable, or not this schema."""
    try:
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
    except Exception:  # noqa: BLE001
        return None
    if not isinstance(meta, dict) or meta.get("schema") != CKPT_SCHEMA:
        return None
    return meta


def restore_checkpoint(ctx, path: str) -> bool:
    """Load ``path`` and apply it to ``ctx``.  Returns ``False`` — never
    raises — when the file is missing/torn/corrupt, carries a stale
    schema, or does not match the context's identity: the caller falls
    back to a fresh run.  Fault site ``ckpt.restore``; span
    ``ckpt.restore`` (phase ``checkpoint``)."""
    from yask_tpu_torch.obs.tracer import span
    with span("ckpt.restore", phase="checkpoint", path=path) as sp:
        fault_point("ckpt.restore")
        try:
            with np.load(path) as data:
                meta = json.loads(bytes(data["__meta__"]).decode())
                if not isinstance(meta, dict) \
                        or meta.get("schema") != CKPT_SCHEMA:
                    sp.set(ok=False)
                    return False
                state = {}
                for name, nslots in meta.get("rings", {}).items():
                    state[name] = [np.array(data[f"{name}__slot{i}"])
                                   for i in range(int(nslots))]
        except Exception:  # noqa: BLE001 - torn/corrupt → fresh run
            sp.set(ok=False)
            return False
        ok = apply_snapshot(ctx, {"meta": meta, "state": state})
        sp.set(ok=bool(ok))
        return ok
