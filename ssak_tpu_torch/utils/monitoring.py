"""Timing, device-memory statistics, profiler traces and throughput
(counterpart of ssak_tpu.utils.monitoring: `logger`, `tic` / `toc` /
`toc_total` / `reset_timers`, `device_memory_stats`, `profile_trace`,
`annotate`, `ThroughputMeter`).

The timers are the same wall-clock code. On the card, memory statistics
come from PyTorch's caching allocator and the driver, a trace from
`torch.profiler` (CUPTI) written as Chrome-trace JSON, and a named region
is a `torch.profiler.record_function`.
"""

import logging
import os
import time

logger = logging.getLogger("ssak_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s|ssak_tpu_torch] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

_CLOCKS = {}
_TOTALS = {}


def tic(name: str = "") -> float:
    """Start (or restart) a named wall-clock timer."""
    t = time.perf_counter()
    _CLOCKS[name] = t
    return t


def toc(name: str = "", stream=None, log_total: bool = False) -> float:
    """Elapsed seconds since tic(name); accumulates per-name totals."""
    t = time.perf_counter() - _CLOCKS.get(name, time.perf_counter())
    _TOTALS[name] = _TOTALS.get(name, 0.0) + t
    if stream is not None:
        msg = f"TIMING {name}: {t:.3f}s"
        if log_total:
            msg += f" (total {_TOTALS[name]:.3f}s)"
        print(msg, file=stream)
    return t


def toc_total(name: str = "") -> float:
    return _TOTALS.get(name, 0.0)


def reset_timers():
    _CLOCKS.clear()
    _TOTALS.clear()


def device_memory_stats(device=None) -> dict:
    """Memory statistics of one device in bytes: `bytes_in_use` and
    `peak_bytes_in_use` from the caching allocator (allocated_bytes.all
    current and peak, the figures of torch.cuda.memory_allocated and
    max_memory_allocated), `bytes_limit` the card's total memory
    (torch.cuda.mem_get_info). None means the current CUDA device and raises
    without a card, as every entry point does (utils.env.resolve_device);
    "cpu" has no allocator statistics and gives the three keys at 0."""
    import torch

    from ssak_tpu_torch.utils.env import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.mem_get_info(dev)[1],
    }


class profile_trace:
    """Context manager around torch.profiler: host activity always, CUDA
    kernels and copies when a card is present. On exit it synchronises the
    card, writes a Chrome-trace JSON into `log_dir` (`path` after exit) and
    logs the path. The trace opens in Perfetto (ui.perfetto.dev) or
    chrome://tracing as it is; `create_perfetto_link` is kept for
    ssak_tpu's signature and does nothing: no link is served.

        with profile_trace("/tmp/ssak-trace"):
            train_step(...)
    """

    def __init__(self, log_dir: str, create_perfetto_link: bool = False):
        self.log_dir = log_dir
        self.create_perfetto_link = create_perfetto_link
        self.path = None
        self.profiler = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=acts)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profiler.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self.profiler.export_chrome_trace(self.path)
        logger.info(f"profiler trace written to {self.path}")
        return False


def annotate(name: str):
    """Named region for profiler timelines (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Tracks audio-seconds processed per wall-clock second."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.audio_seconds = 0.0
        self.steps = 0

    def update(self, audio_seconds: float, steps: int = 1):
        self.audio_seconds += audio_seconds
        self.steps += steps

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def audio_seconds_per_second(self) -> float:
        e = self.elapsed
        return self.audio_seconds / e if e > 0 else 0.0

    def summary(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.elapsed, 3),
            "audio_seconds_per_second": round(self.audio_seconds_per_second, 3),
            "steps": self.steps,
        }
