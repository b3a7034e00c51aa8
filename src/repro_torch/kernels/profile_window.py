"""How often ``torch.profiler`` misses device events on the card, and
whether a quiet margin around the profiled calls stops it.

  python -m repro_torch.kernels.profile_window        (from the repo root)

``chip_smoke.py`` reads launch counts and device times from
``torch.profiler``. The profiler keeps a device event only when it falls
inside its session's window on the host's clock, and the card's timestamps,
mapped onto that clock, can lie off by some amount; a session then misses
the events nearest an edge of its window: a share of a short profile's
launches, or all of them. ``profiled`` opens the session ``margin_s``
before the first call and closes it ``margin_s`` after the card has
finished, so no event lies near an edge.

For two workloads, a PyTorch elementwise op on 4 Mi floats and the
``wkv6_backward`` wrapper at ``chip_smoke.py``'s training shape (B 8,
T 128, H 32, hs 64; three kernels a call, its chunk kernel started by
programmatic dependent launch and, in a second pass, without it),
``SESSIONS`` sessions of 10 and of 50 calls each in four variants taken
in turns (no margin or ``MARGIN_S``; the first call inside the session,
or one call just before it as ``chip_smoke.device_time`` makes), print one
JSON line a variant: the sessions that saw fewer launches than the calls
made, the shares they saw, a few of them by kernel, and where the seen
device events lay against the session's launches on the host (the first
kernel's start after the first launch, the last kernel's end before the
session's last host event; negative: the card's clock puts the kernel
before its launch, or after the host's last event).
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import contextlib
import json
import time

import torch

MARGIN_S = 0.02
SESSIONS = 50
LAUNCH_OPS = ("cudaLaunch", "cuLaunch")


@contextlib.contextmanager
def profiled(margin_s: float = MARGIN_S):
    """A ``torch.profiler`` session of CPU and CUDA activity around the
    block, with ``margin_s`` seconds of quiet on each side: the card is
    drained before the session opens and after the block, and the session
    closes ``margin_s`` after that."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin_s)


def short(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    return name.split("<")[0].split("::")[-1].split("(")[0].removeprefix(
        "void ")


def session(fn, calls: int, launches_a_call: int, margin_s: float,
            warm: bool = False) -> dict:
    """One profiled session of ``calls`` calls of ``fn`` (after one call
    outside it when ``warm``): the device launches seen against those
    made, by kernel, and the seen events' place."""
    if warm:
        fn()
    with profiled(margin_s) as prof:
        for _ in range(calls):
            fn()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    launch = [e for e in host if e.name.startswith(LAUNCH_OPS)]
    names = {}
    for e in dev:
        names[short(e.name)] = names.get(short(e.name), 0) + 1
    order = sorted(dev, key=lambda e: e.time_range.start)
    out = {"seen": len(dev), "made": calls * launches_a_call,
           "launch_events": len(launch), "by_kernel": names,
           "first_kernels": [short(e.name) for e in order[:3]],
           "last_kernels": [short(e.name) for e in order[-3:]]}
    if dev and launch:
        out["first_kernel_after_first_launch_us"] = (
            min(e.time_range.start for e in dev)
            - min(e.time_range.start for e in launch))
        out["last_kernel_before_last_host_event_us"] = (
            max(e.time_range.end for e in host)
            - max(e.time_range.end for e in dev))
    return out


def workloads() -> dict:
    from repro_torch.kernels import rwkv6
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1 << 22, generator=g, device="cuda")
    B, T, H, hs = 8, 128, 32, 64
    n = lambda *s: torch.randn(s, generator=g, device="cuda")
    r, k, v = (n(B, T, H, hs).to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((H, hs), generator=g, device="cuda")
                             * -6.0 - 1.0 + 0.5 * n(B, T, H, hs)))
    u = torch.rand((H, hs), generator=g, device="cuda") * 0.5
    args = (r, k, v, w, u, n(B, H, hs, hs), n(B, T, H, hs).to(torch.bfloat16),
            n(B, H, hs, hs))
    return {"mul_": (lambda: x.mul_(1.0), 1),
            "wkv6_backward": (lambda: rwkv6.backward(*args), 3)}


def main() -> None:
    from repro_torch.kernels import rwkv6
    variants = [(m, warm) for warm in (False, True) for m in (0.0, MARGIN_S)]
    for name, (fn, per_call) in workloads().items():
        for pdl in ((True, False) if name == "wkv6_backward" else (True,)):
            rwkv6.set_backward_pdl(pdl)
            for _ in range(3):
                fn()
            for calls in (10, 50):
                runs = {v: [] for v in variants}
                for _ in range(SESSIONS):
                    for margin, warm in variants:
                        runs[margin, warm].append(
                            session(fn, calls, per_call, margin, warm))
                for (margin, warm), got in runs.items():
                    short = [s for s in got if s["seen"] < s["made"]]
                    print(json.dumps({
                        "workload": name, "pdl": pdl, "calls": calls,
                        "margin_s": margin, "warm_call": warm,
                        "sessions": len(got), "short_sessions": len(short),
                        "over_sessions": sum(s["seen"] > s["made"]
                                             for s in got),
                        "shares_seen": [s["seen"] / s["made"]
                                        for s in short],
                        "short": short[:3],
                        "first_kernel_after_first_launch_us_min": min(
                            (s["first_kernel_after_first_launch_us"]
                             for s in got
                             if "first_kernel_after_first_launch_us" in s),
                            default=None),
                        "last_kernel_before_last_host_event_us_min": min(
                            (s["last_kernel_before_last_host_event_us"]
                             for s in got
                             if "last_kernel_before_last_host_event_us"
                             in s), default=None),
                        "device": torch.cuda.get_device_name(0)}),
                        flush=True)
    rwkv6.set_backward_pdl(True)


if __name__ == "__main__":
    main()
