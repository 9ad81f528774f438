"""Communication-pattern scheduling for the explicit shard modes.

The port's counterpart of ``yask_tpu/parallel/comm_plan.py``.  The
``CommPlan`` is derived once per prepared solution, (mode, K) and knobs
(pure geometry, never raises) and consumed by the exchange executors of
``shard_step``, so the executed schedule and the reported one cannot
drift.  Per mesh axis it decides:

* **ordering**: which axis exchanges first.  Axes whose shards sit on
  different cards (``peer``, a copy over NVLink) go first, their copies
  being the slowest; then axes whose shards share a card (``hbm``, a copy
  inside one card's memory) by descending modelled copy time.  An
  explicit ``-comm_order`` list overrides.
* **coalescing**: every buffer's ghost slab for one (axis, direction)
  packed into one buffer (``torch.cat``) and copied once per neighbour
  pair instead of one copy per buffer.  The copy moves bytes only, so the
  packed schedule is bit-identical to the serial one.  ``auto`` packs
  only where some exchanged axis copies between cards: inside one card
  the pack and the unpack are copies of their own, and no transfer is
  saved.
* **corners**: nothing: diagonal ghosts are composed axis exchanges (a
  later axis's slab spans the earlier axes' freshly filled ghosts), and
  the packed path keeps that because it still goes axis by axis in plan
  order.

The link model replaces the reference's ICI/DCN one (``perflab.roofline``)
with the card's own two transports; see :data:`LINKS`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

#: The two transports of a ghost copy, ``(GB/s of payload, latency µs)``.
#: ``hbm``: both shards on one H100, a device-to-device copy that reads
#: and writes every byte once in the 3.35 TB/s device memory (NVIDIA H100
#: SXM data sheet), so 1,675 GB/s of payload.  ``peer``: two cards of one
#: host over NVLink, 450 GB/s each way (the same data sheet's 900 GB/s
#: total).  The latencies are modelling assumptions for one copy launch,
#: not measurements; they only break ties between small payloads.
LINKS = {"hbm": (1675.0, 5.0), "peer": (450.0, 10.0)}


class CommPlan:
    """One solution's communication schedule (see module docstring).

    ``order``         — mesh axes in exchange order (only axes that
                        actually carry ghost traffic);
    ``coalesce``      — pack all slabs per (axis, direction) into one copy;
    ``axes``          — per-dim model: nranks, hbm/peer kind, payload slabs
                        ("items"), bytes per steady-state round, link
                        GB/s and latency, modelled copy secs;
    ``rounds`` / ``rounds_serial`` — modelled copies per neighbour pair in
                        a full exchange round under this plan vs the serial
                        per-buffer schedule;
    ``reasons``       — structured decision records, ``errors`` — invalid
                        knob messages (the run paths raise on them).
    """

    __slots__ = ("order", "coalesce", "axes", "reasons", "errors",
                 "rounds", "rounds_serial", "mesh_shape", "K", "mode")

    def __init__(self, order, coalesce, axes, reasons, errors,
                 rounds, rounds_serial, mesh_shape, K, mode):
        self.order = list(order)
        self.coalesce = bool(coalesce)
        self.axes = axes
        self.reasons = reasons
        self.errors = errors
        self.rounds = rounds
        self.rounds_serial = rounds_serial
        self.mesh_shape = mesh_shape
        self.K = K
        self.mode = mode

    def key(self):
        """The parts of the plan an exchange schedule bakes in."""
        return (",".join(self.order), self.coalesce)

    def record(self) -> Dict:
        """Structured record for the tiling report, JSON-clean."""
        return {
            "order": list(self.order),
            "coalesce": self.coalesce,
            "mesh": dict(self.mesh_shape),
            "K": self.K,
            "mode": self.mode,
            "axes": {d: dict(a) for d, a in self.axes.items()},
            "rounds": self.rounds,
            "rounds_serial": self.rounds_serial,
            "reasons": [dict(r) for r in self.reasons],
            "errors": list(self.errors),
        }


def mesh_axis_kinds(mesh, dims) -> Dict[str, str]:
    """hbm/peer per mesh axis: an axis along which some row of the grid
    holds more than one distinct device copies between cards (``peer``);
    otherwise every copy stays in one card's memory (``hbm``).  A
    ``None`` mesh (unprepared context) classifies everything ``hbm``."""
    kinds = {d: "hbm" for d in dims}
    if mesh is None:
        return kinds
    devs = mesh.devices
    keys = np.vectorize(str, otypes=[object])(devs)
    for i, name in enumerate(mesh.axis_names):
        if name in kinds and devs.shape[i] > 1:
            first = np.take(keys, [0], axis=i)
            if bool((keys != first).any()):
                kinds[name] = "peer"
    return kinds


def link_secs(nbytes: float, kind: str) -> float:
    """Modelled time of one copy of ``nbytes`` on a link of ``kind``."""
    gbps, lat_us = LINKS[kind]
    return lat_us * 1e-6 + float(nbytes) / (gbps * 1e9)


def order_comm_axes(axis_costs: Dict[str, Dict]) -> list:
    """Peer axes first, then by descending modelled copy time; ties keep
    the input (domain-dim) order (the reference's ``order_comm_axes`` with
    peer in the place of DCN)."""
    dims = list(axis_costs)
    return sorted(
        dims,
        key=lambda d: (0 if axis_costs[d]["kind"] == "peer" else 1,
                       -axis_costs[d]["secs"], dims.index(d)))


def build_comm_plan(ctx, K: Optional[int] = None, prog=None) -> CommPlan:
    """Derive the CommPlan for a configured solution context.

    Pure geometry: never raises, never allocates; invalid knobs land in
    ``plan.errors``.  ``K`` is the group size the exchange serves
    (shard_pallas moves radius×K slabs of the min(K, slots) newest ring
    slots of written vars; shard_map moves every slot at the raw halo
    widths)."""
    opts = ctx._opts
    ana = ctx._ana
    dims = list(ana.domain_dims)
    mode = ctx._mode or opts.mode
    if K is None:
        K = max(opts.wf_steps, 1) if mode == "shard_pallas" else 1
    K = max(int(K), 1)
    if prog is None:
        prog = ctx._program if ctx._program is not None \
            else ctx._plan_geometry()
    nr = {d: int(opts.num_ranks[d]) for d in dims}
    lsizes = opts.rank_domain_sizes
    rad = ana.fused_step_radius()
    hK = {d: rad.get(d, 0) * K for d in dims}
    eb = int(np.dtype(prog.dtype).itemsize)
    reasons: List[dict] = []
    errors: List[str] = []
    kinds = mesh_axis_kinds(getattr(ctx, "_mesh", None), dims)

    # ---- per-axis payload model (the steady-state exchange round) -----
    geoms = [g for g in prog.geoms.values() if not g.is_scratch]
    axes: Dict[str, dict] = {}
    for d in dims:
        if nr.get(d, 1) <= 1 or hK.get(d, 0) <= 0:
            continue
        items = 0
        nbytes = 0
        for g in geoms:
            if d not in g.domain_dims:
                continue
            if mode == "shard_pallas":
                # per-group refresh: written vars only, min(K, slots)
                # newest slots, uniform radius×K widths
                if not g.is_written:
                    continue
                moved = min(K, g.num_slots)
                wl = wr = hK[d]
            else:
                hl, hr = g.var.halo.get(d, (0, 0))
                if (hl, hr) == (0, 0):
                    continue
                moved = g.num_slots
                wl, wr = hl, hr
            cross = 1
            for i, (dn, kind) in enumerate(g.axes):
                if dn == d and kind == "domain":
                    continue
                cross *= (int(lsizes[dn]) if kind == "domain"
                          else int(g.shape[i]))
            items += moved
            nbytes += moved * (wl + wr) * cross * eb
        if items:
            gbps, lat = LINKS[kinds[d]]
            secs = link_secs(nbytes, kinds[d])
            axes[d] = {"nranks": nr[d], "kind": kinds[d],
                       "items": items, "bytes": int(nbytes),
                       "gbps": gbps, "latency_us": lat, "secs": secs}
            reasons.append({"code": "comm_axis", "dim": d,
                            "kind": kinds[d], "items": items,
                            "bytes": int(nbytes),
                            "secs": round(secs, 9)})

    # ---- ordering -----------------------------------------------------
    auto_order = order_comm_axes(
        {d: {"kind": axes[d]["kind"], "secs": axes[d]["secs"]}
         for d in axes})
    setting_order = (getattr(opts, "comm_order", "") or "").strip()
    if setting_order:
        req = [s.strip() for s in setting_order.replace(";", ",")
               .split(",") if s.strip()]
        order: List[str] = []
        for dn in req:
            if dn not in axes:
                errors.append(
                    f"-comm_order names '{dn}' which is not an "
                    f"exchanged mesh axis (have {sorted(axes)})")
            elif dn in order:
                errors.append(f"-comm_order repeats '{dn}'")
            else:
                order.append(dn)
        missing = [d for d in auto_order if d not in order]
        if missing and not errors:
            reasons.append({
                "code": "comm_order_appended", "dims": list(missing),
                "cause": "-comm_order omitted exchanged axes; appended "
                         "in cost-model order"})
        order += missing
        cause = f"explicit -comm_order '{setting_order}'"
    else:
        order = auto_order
        cause = ("cost model: peer axes first, then descending modelled "
                 "copy time")
    reasons.append({"code": "comm_order", "order": list(order),
                    "cause": cause})

    # ---- coalescing ---------------------------------------------------
    rounds_serial = sum(2 * axes[d]["items"] for d in order)
    rounds_coal = 2 * len(order)
    cset = str(getattr(opts, "coalesce", "auto")).lower()
    ccode = None
    if cset in ("on", "true", "1"):
        coal, ccause = True, "coalesce=on (forced)"
    elif cset in ("off", "false", "0"):
        coal, ccause = False, "coalesce=off"
    elif cset == "auto" and order and all(
            axes[d]["kind"] == "hbm" for d in order):
        coal, ccause = False, (
            "auto: every exchanged axis copies inside one card's memory, "
            "where packing copies each slab twice (into the pack, then out "
            "of it) instead of once and saves no transfer")
        ccode = "comm_coalesce_one_card"
    elif cset == "auto":
        coal = rounds_serial > rounds_coal
        ccause = (f"auto: {rounds_serial} serial copies per round "
                  f"vs {rounds_coal} coalesced" if coal else
                  "auto: no axis carries more than one slab — the "
                  "serial schedule already copies once per direction")
    else:
        errors.append(f"-coalesce '{cset}' is not one of on|off|auto")
        coal, ccause = False, "invalid setting"
    rounds = rounds_coal if coal else rounds_serial
    reasons.append({
        "code": ccode or ("comm_coalesce_engaged" if coal
                          else "comm_coalesce_off"),
        "cause": ccause, "rounds": rounds,
        "rounds_serial": rounds_serial})

    mesh_shape = {d: nr[d] for d in dims if nr.get(d, 1) > 1}
    return CommPlan(order=order, coalesce=coal, axes=axes,
                    reasons=reasons, errors=errors, rounds=rounds,
                    rounds_serial=rounds_serial, mesh_shape=mesh_shape,
                    K=K, mode=mode)


def comm_ledger_fields(ctx, plan: Optional[CommPlan] = None) -> Dict:
    """Flat per-row fields of one context's comm schedule: mesh shape,
    per-axis exchange bytes and copy-round counts."""
    if plan is None:
        plan = ctx.comm_plan()
    return {
        "mesh": dict(plan.mesh_shape),
        "comm_order": list(plan.order),
        "coalesce": plan.coalesce,
        "comm_rounds": plan.rounds,
        "comm_rounds_serial": plan.rounds_serial,
        "comm_axis_kb": {d: round(a["bytes"] / 1e3, 2)
                         for d, a in plan.axes.items()},
        "comm_axis_kind": {d: a["kind"] for d, a in plan.axes.items()},
    }
