# Copy of vadc_tpu/cli/stats.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Realtime-factor statistics line, printed to stderr.

Same fields and format as the reference (print_speech_stats,
vadc.c:1037-1081): processed duration as HH:MM:SS.mmmm, total speech seconds,
speech %, processed vs wall seconds, and the realtime factor, updated in
place with a carriage return."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


@dataclass
class Stats:
    output_enabled: bool = False
    sample_rate: int = 16000
    total_samples: int = 0
    total_speech: float = 0.0
    start_time: float = field(default_factory=time.perf_counter)

    @property
    def total_duration(self) -> float:
        return self.total_samples / self.sample_rate

    def add_samples(self, n: int) -> None:
        self.total_samples += n

    def add_speech(self, start_s: float, end_s: float) -> None:
        self.total_speech += end_s - start_s

    def print_line(self, final: bool = False) -> None:
        if not self.output_enabled:
            return
        total = self.total_duration
        wall = time.perf_counter() - self.start_time
        percent = (self.total_speech / total * 100.0) if total > 0 else 0.0
        ratio = (total / wall) if wall > 0 else 0.0
        hours = int(total / 3600)
        minutes = int((total - hours * 3600) / 60)
        seconds = int(total - hours * 3600 - minutes * 60)
        millis = int((total - hours * 3600 - minutes * 60 - seconds) * 1000)
        end = "\n" if final else "\r"
        sys.stderr.write(
            f"time={hours:02d}:{minutes:02d}:{seconds:02d}.{millis:03d}"
            f" {self.total_speech:7.2f} speech ({percent:5.1f}%),"
            f" {total:5.1f} / {wall:5.1f} ({ratio:5.1f}x){end}"
        )
        sys.stderr.flush()
