"""What the per-layer metric readers share.  A reader takes the run's
`Record` (`portbench/run.py`) and returns its number, or None where it
finds nothing to read."""

from __future__ import annotations

from typing import Optional

from portbench import peaks, trace

# the forward kernels of each hand-written kernel family, by name
FLASH_FWD = r"\bflash_fwd(_wgmma)?_kernel\b"
CORR_FWD = r"\b(sweep_kernel|corr_wgmma_kernel|corr_finalize_kernel|corr_combine_kernel|row_lse_kernel|corr_span_kernel)\b"


def per_unit(rec, *phases: str) -> Optional[float]:
    """Seconds a unit of work (an edit) of the named `timings` phases over
    the window's groups; each group's phase time is shared by its edits."""
    if not rec.units or any("timings" not in u for u in rec.units):
        return None
    total = sum(u["timings"][p] for u in rec.units for p in phases)
    return total / sum(u["work"] for u in rec.units)


def mfu(rec) -> Optional[float]:
    """Model FLOPs of the window's work over its time at the bf16 peak, %."""
    if not rec.units or "model_flops" not in rec.work:
        return None
    return 100.0 * rec.work["model_flops"] / (rec.window_s * peaks.BF16_FLOPS)


def roofline(rec, flops: str, n_bytes: str, pattern: str) -> Optional[float]:
    """The least time for the window's work of a kernel family over the
    device time of its kernels, %."""
    if rec.ops is None or not rec.work.get(flops):
        return None
    seconds = trace.own_seconds(rec.ops, pattern, rec.lo, rec.hi)
    if seconds <= 0.0:
        return None
    return 100.0 * peaks.least_seconds(rec.work[flops], rec.work[n_bytes]) / seconds


def device_idle(rec) -> Optional[float]:
    """Share of the traced window that no device operation covers, %."""
    if rec.ops is None:
        return None
    return 100.0 * (1.0 - rec.busy_s * 1e9 / (rec.hi - rec.lo))
