"""The session registry: prepared solutions shared across tenants.

Counterpart of ``yask_tpu/serve/registry.py``.  Two levels:

* :class:`Profile` — ONE prepared ``StencilContext`` per configuration
  (stencil, radius, geometry, wf_steps, extra options) *per mode*.  The
  base mode's context is prepared at registration; a degraded rung's
  context (``degradation_ladder``) is prepared lazily on the first fault
  and cached.  The profile also exposes the batching identity — mode +
  ``ctx._fused_variant_key()`` — the scheduler groups on.
* :class:`Session` — one tenant: a session id bound to a profile, the
  tenant's CURRENT mode, and the tenant's own
  :class:`~yask_tpu_torch.runtime.run_state.RunState` allocated against
  that mode's prepared geometry.

Registering a second tenant on an existing profile costs one zero-filled
state allocation and no kernel build.  A bucketed session
(``serve/buckets.py``) is hosted on a profile at a bucket geometry and
carries its own ``sub_sizes``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from yask_tpu_torch.utils.exceptions import YaskException


class Profile:
    """One registered configuration and its per-mode prepared contexts."""

    def __init__(self, key: Tuple, factory, env, stencil: str,
                 radius: Optional[int], g: str, mode: str, wf: int,
                 options: str = ""):
        self.key = key
        self._factory = factory
        self._env = env
        self.stencil = stencil
        self.radius = radius
        self.g = g
        self.base_mode = mode
        self.wf = wf
        self.options = options
        self._ctxs: Dict[str, object] = {}
        self._lock = threading.RLock()

    def _build(self, mode: str):
        ctx = self._factory.new_solution(self._env, stencil=self.stencil,
                                         radius=self.radius)
        opts = f"-g {self.g} -wf_steps {self.wf}"
        if self.options:
            opts += " " + self.options
        ctx.apply_command_line_options(opts)
        ctx.get_settings().mode = mode
        ctx.prepare_solution()
        return ctx

    def ctx_for(self, mode: str):
        """The prepared context for ``mode`` (lazily built + cached —
        one prepare per (profile, mode) for the server's lifetime)."""
        with self._lock:
            ctx = self._ctxs.get(mode)
            if ctx is None:
                ctx = self._ctxs[mode] = self._build(mode)
            return ctx

    @property
    def ctx(self):
        return self.ctx_for(self.base_mode)

    def variant_key(self, mode: Optional[str] = None) -> Tuple:
        """The kernel-variant component of the batching identity."""
        return self.ctx_for(mode or self.base_mode)._fused_variant_key()

    def modes_prepared(self) -> List[str]:
        with self._lock:
            return sorted(self._ctxs)


class Session:
    """One tenant: its profile, current (possibly degraded) mode, and
    its own RunState under that mode's prepared context.

    A BUCKETED session (shape co-batching, ``serve/buckets.py``)
    is hosted on a profile at a LARGER ladder-rung geometry than the
    tenant requested: ``sub_sizes`` holds the tenant's logical domain
    sizes ({dim: size}, low-corner anchored) and every run masks the
    state to that sub-domain — results stay bit-identical to a solo
    run at the tenant geometry.  ``bucket`` keeps the structured
    :class:`~yask_tpu_torch.serve.buckets.BucketDecision` for
    journaling."""

    def __init__(self, sid: str, profile: Profile,
                 sub_sizes: Optional[Dict[str, int]] = None,
                 bucket=None):
        self.sid = sid
        self.profile = profile
        self.mode = profile.base_mode
        self.run_state = profile.ctx.new_run_state()
        #: tenant's logical domain sizes when bucket-hosted (None =
        #: the session occupies the profile's full geometry).
        self.sub_sizes = dict(sub_sizes) if sub_sizes else None
        #: the BucketDecision that placed this session (None = the
        #: pre-bucketing open path).
        self.bucket = bucket
        #: ladder rungs this session has been walked down, in order.
        self.degrade_path: List[str] = []

    @property
    def ctx(self):
        return self.profile.ctx_for(self.mode)

    @property
    def degraded(self) -> bool:
        return bool(self.degrade_path)


class SessionRegistry:
    """Profiles + sessions, with profile dedup by configuration key."""

    def __init__(self, factory, env):
        self._factory = factory
        self._env = env
        self._profiles: Dict[Tuple, Profile] = {}
        self._sessions: Dict[str, Session] = {}
        self._lock = threading.RLock()
        self._next_sid = 0

    @staticmethod
    def profile_key(stencil: str, radius: Optional[int], g,
                    mode: str, wf: int, options: str = "") -> Tuple:
        return (str(stencil), radius, str(g), str(mode), int(wf),
                str(options or "").strip())

    def get_profile(self, stencil: str, radius: Optional[int], g,
                    mode: str = "torch", wf: int = 2,
                    options: str = "") -> Profile:
        """The profile for this configuration, preparing it on first
        registration (the expensive step — later tenants share it)."""
        key = self.profile_key(stencil, radius, g, mode, wf, options)
        with self._lock:
            prof = self._profiles.get(key)
            if prof is None:
                prof = Profile(key, self._factory, self._env,
                               str(stencil), radius, str(g), str(mode),
                               int(wf), str(options or "").strip())
                prof.ctx  # prepare the base mode eagerly
                self._profiles[key] = prof
            return prof

    def open_session(self, profile: Profile,
                     session: Optional[str] = None,
                     sub_sizes: Optional[Dict[str, int]] = None,
                     bucket=None) -> Session:
        with self._lock:
            if session is None:
                session = f"s{self._next_sid:04d}"
                self._next_sid += 1
            if session in self._sessions:
                raise YaskException(
                    f"serve session {session!r} already open")
            s = Session(str(session), profile, sub_sizes=sub_sizes,
                        bucket=bucket)
            self._sessions[s.sid] = s
            return s

    def session(self, sid: str) -> Session:
        with self._lock:
            s = self._sessions.get(str(sid))
            if s is None:
                raise YaskException(f"unknown serve session {sid!r}")
            return s

    def close_session(self, sid: str) -> None:
        with self._lock:
            self._sessions.pop(str(sid), None)

    def sessions(self) -> List[Session]:
        with self._lock:
            return list(self._sessions.values())

    def profiles(self) -> List[Profile]:
        with self._lock:
            return list(self._profiles.values())
