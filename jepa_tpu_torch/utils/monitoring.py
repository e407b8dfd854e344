"""Host resource monitoring thread: CPU, memory and IO counters of this
process on an interval (counterpart of jepa_tpu/utils/monitoring.py;
reference src/utils/monitoring.py:45-164, a psutil sampler with a
callback). Given a log_dir it appends to ``<log_dir>/resources_r{rank}.csv``,
the reference's intended ``log_resource_utilization`` wiring.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

CSV_HEADER = "timestamp,cpu_percent,rss_mb,read_mb,write_mb,num_threads,ctx_switches\n"


@dataclasses.dataclass
class ResourceSample:
    timestamp: float
    cpu_percent: float
    rss_mb: float
    read_mb: float
    write_mb: float
    num_threads: int
    ctx_switches: int


def sample_counters(process=None) -> ResourceSample:
    """One sample of ``process`` (default: this one). cpu_percent is the
    share since the previous call on the same ``psutil.Process``."""
    import psutil

    p = process or psutil.Process(os.getpid())
    with p.oneshot():
        try:
            io = p.io_counters()
        except (psutil.AccessDenied, AttributeError):  # no IO counters here
            io = None
        ctx = p.num_ctx_switches()
        return ResourceSample(
            timestamp=time.time(),
            cpu_percent=p.cpu_percent(interval=None),
            rss_mb=p.memory_info().rss / 1024**2,
            read_mb=(io.read_bytes / 1024**2) if io else 0.0,
            write_mb=(io.write_bytes / 1024**2) if io else 0.0,
            num_threads=p.num_threads(),
            ctx_switches=ctx.voluntary + ctx.involuntary,
        )


class ResourceMonitoringThread(threading.Thread):
    """Sample resource counters every ``interval_s``; invoke ``callback`` or
    append to <log_dir>/resources_r{rank}.csv (its header is written at
    construction)."""

    def __init__(
        self,
        interval_s: float = 30.0,
        callback: Optional[Callable[[ResourceSample], None]] = None,
        log_dir: Optional[str] = None,
        rank: int = 0,
    ):
        super().__init__(daemon=True)
        self.interval_s = interval_s
        self.callback = callback
        self._stop_event = threading.Event()
        self.csv_path = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.csv_path = os.path.join(log_dir, f"resources_r{rank}.csv")
            with open(self.csv_path, "a") as f:
                f.write(CSV_HEADER)

    def stop(self):
        self._stop_event.set()

    def run(self):
        try:
            import psutil

            proc = psutil.Process(os.getpid())
            proc.cpu_percent(interval=None)  # prime the counter
        except ImportError as e:
            logger.warning("resource monitoring unavailable: %s", e)
            return
        while not self._stop_event.wait(self.interval_s):
            s = sample_counters(proc)
            if self.callback:
                self.callback(s)
            if self.csv_path:
                with open(self.csv_path, "a") as f:
                    f.write(
                        f"{s.timestamp:.1f},{s.cpu_percent:.1f},{s.rss_mb:.1f},"
                        f"{s.read_mb:.1f},{s.write_mb:.1f},{s.num_threads},{s.ctx_switches}\n"
                    )
