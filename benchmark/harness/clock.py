"""The run's clock, in the standard library alone, so that it starts before
torch is imported."""
import os
import time
from typing import Callable


def clock() -> Callable[[], float]:
    """Seconds since this process started: the kernel's start time of the
    process against the boot clock, read now, plus the time counted from
    here; the time from here alone where /proc cannot say."""
    t = time.perf_counter()
    before = 0.0
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        before = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        pass
    return lambda: before + time.perf_counter() - t


class Stopwatch:
    """Named stretches of set-up, printed as one line on standard error."""

    def __init__(self, since_start: Callable[[], float]):
        self.since_start = since_start
        self.last = since_start()
        self.parts = [("before set-up", self.last)]

    def mark(self, name: str) -> None:
        now = self.since_start()
        self.parts.append((name, now - self.last))
        self.last = now

    def line(self) -> str:
        return "set-up: " + ", ".join(f"{n} {s:.3f} s" for n, s in self.parts)
