"""The arithmetic of the per-layer metrics, each over the context a run
hands its readers (``run.py``).  A reader that finds nothing to read
returns None, and the run leaves its metric out."""

from __future__ import annotations

from typing import Optional

from port_bench.flops import KERNEL_NAMES, PEAK_BF16


def device_idle(ctx) -> Optional[float]:
    """Percent of the traced window in which no kernel, copy or fill ran
    on the device (the union of their intervals; annotation rows left
    out)."""
    tr = ctx.get("trace")
    if not tr or tr["idle_share"] is None:
        return None
    return 100.0 * tr["idle_share"]


def mfu(ctx) -> Optional[float]:
    """Model FLOPs of the work the window consumed (``flops.py``) over the
    window's wall at the card's bf16 peak, in percent."""
    if not ctx.get("model_flops") or not ctx.get("wall_s"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["wall_s"] * PEAK_BF16)


def kernel_roofline(ctx) -> Optional[float]:
    """The LSTM kernels' least time (from the launch shapes) over their
    measured device time in the trace, in percent."""
    tr = ctx.get("trace")
    if not tr:
        return None
    measured = sum(ns for name, ns in tr["kernel_ns"].items()
                   if any(k in name for k in KERNEL_NAMES)) / 1e9
    if measured <= 0.0 or not ctx.get("kernel_bound_s"):
        return None
    return 100.0 * ctx["kernel_bound_s"] / measured


def starved_share(ctx) -> Optional[float]:
    """Slot-steps whose slot found no episode to refill from, over all
    slot-steps of the window, in percent."""
    if ctx.get("starved") is None or not ctx.get("slot_steps"):
        return None
    return 100.0 * ctx["starved"] / ctx["slot_steps"]


def agent_steps_per_s(ctx) -> Optional[float]:
    if not ctx.get("wall_s"):
        return None
    return ctx["agent_steps"] / ctx["wall_s"]
