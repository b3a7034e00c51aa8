"""The device trace of a traced run: one ``torch.profiler`` session over a
few steady round steps, and what the per-layer readers take from it.

The session records the device's activity alone: recording the host's
operations as well doubles the host's time a step where the host sets
the pace, and that slowdown would read as idle device time. One more
step, with the host's operations recorded, only names the idle gaps
(``idle_gaps``); none of its times is a metric.

``profiled`` is the port's ``kernels/profile_window.profiled``, copied so
that the yardstick does not move with the program: the card is drained,
then ``MARGIN_S`` of quiet on each side of the profiled calls, so no
device event falls near an edge of the session (the profiler drops those
whose card time, mapped onto the host's clock, lies outside it).

``Trace`` holds the device intervals (kernels, copies and sets) and the
host operations, each with its start and end in microseconds on the
profiler's clock.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

MARGIN_S = 0.02
NOT_KERNELS = ("Memcpy", "Memset")


@contextlib.contextmanager
def profiled(host: bool = False, margin_s: float = MARGIN_S):
    """A profiler session of the device's activity, and with ``host`` of
    the host's operations too."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + \
        ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        time.sleep(margin_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin_s)


def short(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    return name.split("<")[0].split("::")[-1].split("(")[0].removeprefix(
        "void ").strip()


@dataclass
class Trace:
    steps: int = 0
    wall_s: float = 0.0
    device: list = field(default_factory=list)   # (start_us, end_us, name)
    host: list = field(default_factory=list)     # (start_us, end_us, name)

    @classmethod
    def from_profile(cls, prof, steps: int, wall_s: float) -> "Trace":
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            elif e.device_type == torch.autograd.DeviceType.CPU:
                host.append((tr.start, tr.end, e.name))
        dev.sort()
        host.sort()
        return cls(steps, wall_s, dev, host)

    def kernels(self) -> list:
        return [d for d in self.device if not d[2].startswith(NOT_KERNELS)]

    def device_s(self, match) -> float:
        """Device seconds of the intervals whose name ``match`` accepts."""
        return sum(e - s for s, e, n in self.device if match(n)) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device intervals, merged."""
        out = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[[kernel name, device seconds]] of the n that took most time."""
        by = {}
        for s, e, name in self.device:
            k = short(name)
            by[k] = by.get(k, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]]: every gap between the
        device's busy intervals, named by the innermost host operation
        running at its middle, the one that started last ('host: no
        operation' where none was), summed by name; the n largest."""
        busy = self.busy_intervals()
        by, live, i = {}, [], 0
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            while i < len(self.host) and self.host[i][0] <= mid:
                live.append(self.host[i])
                i += 1
            while live and live[-1][1] < mid:    # ended: for later gaps too
                live.pop()
            key = live[-1][2] if live else "host: no operation"
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]
