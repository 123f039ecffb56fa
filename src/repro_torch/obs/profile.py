"""EXPLAIN ANALYZE — executed-plan profiling with the first-call split
(docs/ARCHITECTURE.md §13).

``PropGraph.explain()`` shows the plan the optimizer CHOSE;
``explain_analyze()`` runs it and reports where the wall time WENT:
per-stage times (parse, plan, mask materialization, propagation) and how
much of the first call was a one-off cost rather than device work.

The port compiles nothing per shape, so its first call pays other things:
the lazy load of a kernel library (``kernels/_build.py``), the caching
allocator's first blocks, and the first use of a CUDA library.  The split
is measured, not inferred: each device stage runs twice and the graph's
device is synchronized after each run (``torch.cuda.synchronize`` on the
card, nothing on the CPU), so

    compile_ms ≈ first_ms − steady_ms   per stage,

where a stage's steady time is the faster of its two runs: a re-run
slower than the first was slowed by something else (the host's jitter),
not by steady-state work, so the first call's total is never below the
steady total.

The field keeps the reference's name so that ``to_dict()`` and the wire's
``explain`` carry the same keys.  On a warm process both runs take about
the same time and ``compile_ms`` ≈ 0.  The re-run costs one extra
steady-state execution; that is the price of an honest number and why
this is a profiling verb, not the default path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.obs import metrics as _metrics

__all__ = ["ProfileReport", "profile_match"]

_now = time.perf_counter

# below this, first-vs-steady deltas are timer noise, not a one-off cost
_COMPILE_NOISE_MS = 0.5


@dataclass
class ProfileReport:
    """Executed-plan annotation returned by ``explain_analyze()`` /
    ``match(..., profile=True)``.  All times in milliseconds; ``*_first``
    is the as-observed first call, the unsuffixed device-stage fields the
    steady state: the faster of the first run and the re-run."""

    plan: Any
    parse_ms: float
    plan_ms: float
    masks_first_ms: float
    masks_ms: float
    execute_first_ms: float
    execute_ms: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def compile_ms(self) -> float:
        """The first call's one-off share: kernel library load, allocator
        and library warm-up (the reference's XLA compilation)."""
        c = (max(0.0, self.masks_first_ms - self.masks_ms)
             + max(0.0, self.execute_first_ms - self.execute_ms))
        return c if c >= _COMPILE_NOISE_MS else 0.0

    @property
    def cold(self) -> bool:
        """True iff the first call visibly paid a one-off cost."""
        return self.compile_ms > 0.0

    @property
    def total_first_ms(self) -> float:
        return (self.parse_ms + self.plan_ms
                + self.masks_first_ms + self.execute_first_ms)

    @property
    def steady_ms(self) -> float:
        return self.parse_ms + self.plan_ms + self.masks_ms + self.execute_ms

    def to_dict(self) -> Dict[str, Any]:
        return {
            "parse_ms": round(self.parse_ms, 4),
            "plan_ms": round(self.plan_ms, 4),
            "masks_first_ms": round(self.masks_first_ms, 4),
            "masks_ms": round(self.masks_ms, 4),
            "execute_first_ms": round(self.execute_first_ms, 4),
            "execute_ms": round(self.execute_ms, 4),
            "compile_ms": round(self.compile_ms, 4),
            "total_first_ms": round(self.total_first_ms, 4),
            "steady_ms": round(self.steady_ms, 4),
            "cold": self.cold,
            **self.attrs,
        }

    def describe(self) -> str:
        """``Plan.describe()`` plus the measured timing annotation."""
        n_steps = len(self.plan.mask_steps)
        n_fused = len(self.plan.fused_node_slots)
        lines = [self.plan.describe(), "-- analyze --"]
        lines.append(f"  parse                {self.parse_ms:9.3f} ms")
        lines.append(f"  plan                 {self.plan_ms:9.3f} ms")
        lines.append(
            f"  {'masks (%d steps, %d fused)' % (n_steps, n_fused):<21}"
            f" first {self.masks_first_ms:9.3f} ms"
            f" / steady {self.masks_ms:9.3f} ms")
        lines.append(
            f"  propagate            first {self.execute_first_ms:9.3f} ms"
            f" / steady {self.execute_ms:9.3f} ms")
        if self.cold:
            lines.append(
                f"  compile (first call) {self.compile_ms:9.3f} ms"
                "  <- kernel library load, allocator and library warm-up,"
                " absent once warm")
        else:
            lines.append("  compile (first call)     ~0       ms  (process warm)")
        lines.append(
            f"  total                first {self.total_first_ms:9.3f} ms"
            f" / steady {self.steady_ms:9.3f} ms")
        return "\n".join(lines)


def _sync(device) -> None:
    """Wait for the graph's device: the card's queue, nothing on the CPU.
    (``torch`` is imported here, so that ``repro_torch.obs`` imports none.)"""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def profile_match(pg, pattern, *, impl: Optional[str] = None):
    """Run ``pattern`` against ``pg`` with per-stage timing; returns
    ``(MatchResult, ProfileReport)``.  Implements
    ``PropGraph.match(..., profile=True)`` and ``explain_analyze()``."""
    from repro_torch.query import execute_plan_with_masks, parse, plan_pattern
    from repro_torch.query.executor import _materialize

    t0 = _now()
    pat = parse(pattern) if isinstance(pattern, str) else pattern
    t1 = _now()
    plan = plan_pattern(pg, pat, impl=impl)
    t2 = _now()

    device = pg._require_graph().device
    label_masks, rel_masks = _materialize(pg, plan, "query_any_batched", "query_any")
    _sync(device)
    t3 = _now()
    label_masks, rel_masks = _materialize(pg, plan, "query_any_batched", "query_any")
    _sync(device)
    t4 = _now()

    result = execute_plan_with_masks(pg, plan, label_masks, rel_masks)
    _sync(device)
    t5 = _now()
    result = execute_plan_with_masks(pg, plan, label_masks, rel_masks)
    _sync(device)
    t6 = _now()

    masks_first_ms, execute_first_ms = (t3 - t2) * 1e3, (t5 - t4) * 1e3
    report = ProfileReport(
        plan=plan,
        parse_ms=(t1 - t0) * 1e3,
        plan_ms=(t2 - t1) * 1e3,
        masks_first_ms=masks_first_ms,
        masks_ms=min(masks_first_ms, (t4 - t3) * 1e3),
        execute_first_ms=execute_first_ms,
        execute_ms=min(execute_first_ms, (t6 - t5) * 1e3),
        attrs={"backend": plan.backend,
               "mask_steps": len(plan.mask_steps),
               "fused_slots": len(plan.fused_node_slots),
               "traversal": plan.has_traversal},
    )
    _metrics.GLOBAL.counter(
        "pg_profile_runs", "explain_analyze invocations").inc()
    return result, report
