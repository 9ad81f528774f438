"""Run statistics: the ``yk_stats`` API.

Counterpart of ``yask_tpu/runtime/stats.py`` without the halo-calibration
fields of the shard modes (they come with ROADMAP.md A11); the reference's
``Stats``/``yk_stats``
(``src/kernel/lib/context.hpp:145-198``, printed by ``get_stats``,
``soln_apis.cpp:349,536-551``): points/reads/writes/FLOP throughput over the
steps done since the last reset, plus the per-phase timer breakdown the
reference keeps for halo exchange (``context.hpp:318-328``).
"""

from __future__ import annotations


class yk_stats:
    def __init__(self, npts: int, nsteps: int, nreads_pp: int,
                 nwrites_pp: int, nfpops_pp: int, elapsed: float,
                 halo_secs: float = 0.0, compile_secs: float = 0.0,
                 read_bytes_pp: float = 0.0, write_bytes_pp: float = 0.0,
                 hbm_peak: float = 0.0, tiling: dict | None = None):
        self._npts = npts
        self._nsteps = nsteps
        self._nreads_pp = nreads_pp
        self._nwrites_pp = nwrites_pp
        self._nfpops_pp = nfpops_pp
        self._elapsed = elapsed
        self._halo = halo_secs
        self._compile = compile_secs
        self._rb_pp = read_bytes_pp
        self._wb_pp = write_bytes_pp
        self._hbm_peak = hbm_peak
        self._tiling = tiling

    def get_tiling(self) -> dict | None:
        """The tiling the fused kernel actually ran with (tile extents,
        launches per step, ``pipeline_dmas``/``skew_dims``), or None on
        other paths / before the first build.  Returns a copy."""
        if self._tiling is None:
            return None
        return dict(self._tiling)

    def get_num_elements(self) -> int:
        """Points in the global domain (per step)."""
        return self._npts

    def get_num_steps_done(self) -> int:
        return self._nsteps

    def get_num_writes_done(self) -> int:
        return self._npts * self._nwrites_pp * self._nsteps

    def get_num_reads_done(self) -> int:
        return self._npts * self._nreads_pp * self._nsteps

    def get_est_fp_ops_done(self) -> int:
        return self._npts * self._nfpops_pp * self._nsteps

    def get_elapsed_secs(self) -> float:
        return self._elapsed

    def get_halo_secs(self) -> float:
        return self._halo

    def get_compile_secs(self) -> float:
        """Kernel build time (nvcc at first use) excluded from throughput
        (the analog of the reference excluding auto-tuner warmup)."""
        return self._compile

    # -- derived throughput (the log lines YaskUtils.pm:40-58 scrapes) -----

    def get_pts_per_sec(self) -> float:
        tot = self._npts * self._nsteps
        return tot / self._elapsed if self._elapsed > 0 else 0.0

    def get_flops(self) -> float:
        return (self.get_est_fp_ops_done() / self._elapsed
                if self._elapsed > 0 else 0.0)

    def get_hbm_bytes_per_point(self) -> float:
        """Modeled device-memory traffic (read+write) per point per step."""
        return self._rb_pp + self._wb_pp

    def get_hbm_bytes_per_sec(self) -> float:
        return self.get_pts_per_sec() * self.get_hbm_bytes_per_point()

    def get_hbm_roofline_fraction(self) -> float:
        """Achieved / peak device-memory bandwidth (0 when the peak is
        unknown)."""
        if self._hbm_peak <= 0:
            return 0.0
        return self.get_hbm_bytes_per_sec() / self._hbm_peak

    def format(self) -> str:
        gpts = self.get_pts_per_sec() / 1e9
        return (f"num-points-per-step: {self._npts}\n"
                f"num-steps-done: {self._nsteps}\n"
                f"elapsed-time (sec): {self._elapsed:.6g}\n"
                f"throughput (num-points/sec): {self.get_pts_per_sec():.6g}\n"
                f"throughput (GPts/s): {gpts:.6g}\n"
                f"throughput (est-FLOPS): {self.get_flops():.6g}\n"
                f"halo-time (sec): {self._halo:.6g}\n"
                f"hbm-bytes-per-point (read+write): "
                f"{self.get_hbm_bytes_per_point():.6g}\n"
                f"achieved-HBM (GB/s): "
                f"{self.get_hbm_bytes_per_sec() / 1e9:.6g}\n"
                f"hbm-roofline-fraction (%): "
                f"{100.0 * self.get_hbm_roofline_fraction():.4g}\n"
                + (f"fused-tiling: {self._tiling}\n"
                   if self._tiling else "")
                + f"compile-time (sec): {self._compile:.6g}\n")
