"""Logging and throughput metering (counterpart of the host half of
ssak_tpu.utils.monitoring: `logger`, `ThroughputMeter`)."""

import logging
import time

logger = logging.getLogger("ssak_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s|ssak_tpu_torch] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


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
