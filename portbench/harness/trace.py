"""The device trace of a traced window, reduced to what the per-layer
metrics read.

``torch.profiler`` records the card's activity only (no host operators,
which would cost more than the window itself). Its events give each
kernel's and copy's interval on the card; the busy time is the union of
those intervals, the idle share its complement over the window. Host
spans, recorded by the harness around calls into the program, are put on
the device clock through a marker kernel launched at a known host time, so
that each idle gap can be charged to what the host was doing.
"""

from __future__ import annotations

import contextlib
import resource
import time
from dataclasses import dataclass, field

# the port's hand-written kernels, as the profiler names them
PORT_KERNELS = ("h_stats_kernel", "w_numer_prep_kernel", "w_numer_kernel",
                "beta_err", "h_newton", "wh_at_nz")
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Spans:
    """Host spans on the host clock (``time.perf_counter_ns``): ``(label,
    start_ns, end_ns)``; an idle gap is charged to the shortest span that
    covers it."""
    items: list = field(default_factory=list)

    def span(self, label: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter_ns()

            def __exit__(self, *exc):
                spans.items.append((label, self.t0, time.perf_counter_ns()))
                return False
        return _Span()


def kind_of(name: str) -> str:
    """``kl_ell`` (the port's kernels), ``gemm`` (cuBLAS and CUTLASS matrix
    products), ``copy`` (copies and fills by the copy engines) or ``glue``
    (every other kernel: torch's elementwise and reduction kernels)."""
    if any(k in name for k in PORT_KERNELS):
        return "kl_ell"
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copy"
    if ("gemm" in low or "gemv" in low or "xmma" in low or "cutlass" in low
            or low.startswith(("sm90_", "sm80_", "ampere_", "cublas"))):
        return "gemm"
    return "glue"


def device_events(prof) -> list[DeviceEvent]:
    """The card's events of a stopped ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [DeviceEvent(e.name(), int(e.start_ns()),
                        int(e.start_ns()) + int(e.duration_ns()))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


@contextlib.contextmanager
def profiled(on: bool):
    """A running ``torch.profiler.profile`` of the card's activity, or
    None when ``on`` is false."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def marker(device) -> int:
    """Launch the marker kernel after the card is idle; return the host
    time of its launch."""
    import torch

    torch.cuda.synchronize(device)
    t = time.perf_counter_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    return t


def cpu_s() -> tuple[float, float]:
    """This process's host CPU seconds, every thread's: ``(user, system)``
    (the system's share is the kernel's work for the process: file writes,
    page reclaim, waits that spin in the driver's calls)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


def busy_intervals(events: list[DeviceEvent]) -> list[tuple[int, int]]:
    """The union of the events' intervals, in order."""
    out: list[list[int]] = []
    for e in sorted(events, key=lambda e: e.start_ns):
        if out and e.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end_ns)
        else:
            out.append([e.start_ns, e.end_ns])
    return [(a, b) for a, b in out]


def reduce(events: list[DeviceEvent], window_s: float, spans: Spans,
           marker_host_ns: int | None) -> dict:
    """Busy seconds, seconds by kind and by kernel name, and the idle time
    inside the window charged to host spans."""
    marker = [e for e in events if MARKER in e.name]
    work = [e for e in events if MARKER not in e.name]
    busy = busy_intervals(work)
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in work:
        k = kind_of(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + e.seconds
        by_name[e.name] = by_name.get(e.name, 0.0) + e.seconds
    idle: dict[str, list] = {}
    if marker and marker_host_ns is not None and busy:
        offset = marker[0].start_ns - marker_host_ns
        host = [(lbl, a + offset, b + offset) for lbl, a, b in spans.items]
        job = [s for s in host if s[0] == "job"]
        lo = job[0][1] if job else busy[0][0]
        hi = job[0][2] if job else busy[-1][1]
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            mid = (a + b) // 2
            inner = [s for s in host if s[1] <= mid <= s[2] and s[0] != "job"]
            label = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                     else "factorize, other host work")
            rec = idle.setdefault(label, [0.0, 0, 0.0])
            rec[0] += (b - a) / 1e9
            rec[1] += 1
            rec[2] = max(rec[2], (b - a) / 1e9)
    return {"busy_s": busy_s, "window_s": window_s, "by_kind": by_kind,
            "by_name": by_name, "idle_by_host": idle,
            "n_events": len(work)}
