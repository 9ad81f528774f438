"""Result-sanity guards: validate outputs before they are released.

Counterpart of ``yask_tpu/resilience/sanity.py``.  A served answer that
came back all zero, or with NaN/Inf anywhere, is turned into a
structured ``ANOMALY`` verdict:

* **all-zero** — a zero fraction above :data:`ZERO_FRAC_MAX` on data
  that was seeded nonzero means the device returned nothing;
* **non-finite** — NaN/Inf anywhere (divergence or a corrupt write);
* **oracle mismatch** — relative L2 error against a reference beyond
  tolerance, where one is given.

A failed verdict never drops the data silently: the server releases it
flagged (``anomaly``), never banked clean.  Tensors are read through the
host (``.cpu()``).
"""

from __future__ import annotations

from typing import Dict, List

#: zero fraction at/above which seeded data counts as "came back
#: all-zero".  High enough that legitimately sparse fields (an impulse
#: a few steps old is checked via an interior slice, not the full
#: domain) never trip it.
ZERO_FRAC_MAX = 0.999

#: default relative-L2 tolerance against a CPU oracle.
ORACLE_REL_TOL = 0.05


def _host(a):
    """A numpy view of an ndarray or a tensor on any device."""
    import numpy as np
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _as_arrays(data) -> List:
    """Flatten an ndarray / tensor / list of them / var→ring state dict
    into a list of numpy arrays."""
    if isinstance(data, dict):
        out = []
        for ring in data.values():
            for a in (ring if isinstance(ring, (list, tuple))
                      else [ring]):
                out.append(_host(a))
        return out
    if isinstance(data, (list, tuple)):
        return [_host(a) for a in data]
    return [_host(data)]


def array_stats(data) -> Dict:
    """Aggregate {n, zero_frac, nonfinite_frac, max_abs} over arrays /
    state dicts (tensors are read through the host)."""
    import numpy as np
    n = zeros = nonfinite = 0
    max_abs = 0.0
    for a in _as_arrays(data):
        if a.size == 0:
            continue
        a = np.asarray(a, dtype=np.float64)
        n += a.size
        finite = np.isfinite(a)
        nonfinite += int(a.size - int(finite.sum()))
        zeros += int((a == 0.0).sum())
        if finite.any():
            max_abs = max(max_abs, float(np.abs(a[finite]).max()))
    return {"n": n,
            "zero_frac": (zeros / n) if n else 0.0,
            "nonfinite_frac": (nonfinite / n) if n else 0.0,
            "max_abs": max_abs}


def check_output(data, oracle=None, rel_tol: float = ORACLE_REL_TOL,
                 zero_frac_max: float = ZERO_FRAC_MAX) -> Dict:
    """The sanity verdict for one measurement's backing data.

    Returns ``{"ok": bool, "anomalies": [...], **array_stats}`` (plus
    ``oracle_rel_err`` when an oracle was supplied).  ``data`` and
    ``oracle`` accept an ndarray, a list of ndarrays, or a var→ring
    state dict."""
    import numpy as np
    stats = array_stats(data)
    anomalies: List[str] = []
    if stats["n"] and stats["nonfinite_frac"] > 0.0:
        anomalies.append("nonfinite")
    if stats["n"] and stats["zero_frac"] >= zero_frac_max:
        anomalies.append("all_zero")
    verdict = {"anomalies": anomalies, **stats}
    if oracle is not None:
        got = np.concatenate([np.asarray(a, dtype=np.float64).ravel()
                              for a in _as_arrays(data)])
        want = np.concatenate([np.asarray(a, dtype=np.float64).ravel()
                               for a in _as_arrays(oracle)])
        if got.shape == want.shape and want.size:
            denom = float(np.linalg.norm(want))
            err = float(np.linalg.norm(got - want)) / max(denom, 1e-30)
            verdict["oracle_rel_err"] = round(err, 6)
            if not np.isfinite(err) or err > rel_tol:
                anomalies.append("oracle_mismatch")
        else:
            anomalies.append("oracle_shape_mismatch")
    verdict["ok"] = not anomalies
    return verdict


def anomaly_fields(verdict: Dict) -> Dict:
    """The fields a quarantined answer carries (the server puts
    ``anomaly`` on the response)."""
    return {"quarantined": True,
            "anomaly": {"classification": "ANOMALY",
                        "anomalies": list(verdict.get("anomalies", [])),
                        **{k: round(verdict[k], 6)
                           for k in ("zero_frac", "nonfinite_frac",
                                     "max_abs", "oracle_rel_err")
                           if k in verdict}}}
