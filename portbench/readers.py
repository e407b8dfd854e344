"""Arithmetic shared by the metric readers of portbench/metrics/. A reader
returns None where its cell gives it nothing to read; a share of a bound or
a peak is then left out, never reported as 0."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.flops import PEAK_BF16_FLOPS


def window(m: dict, kind: str) -> Optional[dict]:
    w = m.get("window")
    return w if w is not None and w["kind"] == kind else None


def rate(m: dict, kind: str) -> Optional[float]:
    w = window(m, kind)
    return None if w is None else w["items"] / w["window_s"]


def p90_ms(m: dict, kind: str) -> Optional[float]:
    w = window(m, kind)
    if w is None or len(w.get("latencies_s", [])) < 2:
        return None
    return statistics.quantiles(w["latencies_s"], n=10, method="inclusive")[8] * 1e3


def mfu(m: dict, kind: str) -> Optional[float]:
    w = window(m, kind)
    return None if w is None else 100.0 * w["flops"] / w["window_s"] / PEAK_BF16_FLOPS


def _slice(m: dict, kind: str) -> Optional[dict]:
    s = m.get("slice")
    return s if s is not None and m.get("kind") == kind else None


def kernel_ms_per_item(m: dict, kind: str, category: str) -> Optional[float]:
    s = _slice(m, kind)
    return None if s is None else s["trace"]["kernel_ms"][category] / s["items"]


def roofline(m: dict, kind: str, category: str, bound_key: str) -> Optional[float]:
    s = _slice(m, kind)
    if s is None or not s.get(bound_key) or s["trace"]["kernel_ms"][category] <= 0:
        return None
    return 100.0 * s[bound_key] / s["trace"]["kernel_ms"][category]


def idle_pct(m: dict, kind: str) -> Optional[float]:
    s = _slice(m, kind)
    if s is None:
        return None
    t = s["trace"]
    return 100.0 * (1.0 - t["busy_ms"] / t["window_ms"])


def peak_gib(m: dict, kind: str) -> Optional[float]:
    return None if window(m, kind) is None else m["peak_window_bytes"] / 2**30
