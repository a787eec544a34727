"""The traced run: ``torch.profiler`` (host and device) around a callable,
reduced to device intervals, host intervals and the harness's own spans.

Spans are ``record_function`` ranges named ``bench.<layer>`` that the
harness puts around its calls into the program's layers (``span``); the
program itself is not instrumented.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class Trace:
    device: list      # (name, start_s, end_s) of every device activity
    host: list        # (name, start_s, end_s) of host ops and harness spans
    window_s: float   # host-clock length of the traced call
    t0: float         # the traced call's start on the profiler's clock, s

    def union_s(self) -> float:
        """Seconds of the traced window in which something ran on the
        device."""
        lo, hi = self.t0, self.t0 + self.window_s
        ivs = sorted((max(a, lo), min(b, hi)) for _, a, b in self.device)
        total, cur_a, cur_b = 0.0, None, None
        for a, b in ivs:
            if b <= a:
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total

    def kernel_seconds(self, names) -> float:
        """Summed device time of the activities whose name holds any of
        ``names``."""
        return sum(b - a for n, a, b in self.device if any(k in n for k in names))

    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches of the window with nothing on the
        device, each named by the innermost harness span and host op that
        cover its middle."""
        lo, hi = self.t0, self.t0 + self.window_s
        ivs = sorted((a, b) for _, a, b in self.device)
        gaps, cur = [], lo
        for a, b in ivs:
            if a > cur:
                gaps.append((cur, min(a, hi)))
            cur = max(cur, b)
        if cur < hi:
            gaps.append((cur, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            span, op = "", ""
            span_start = op_start = -1.0
            for name, s, e in self.host:
                if s <= mid <= e:
                    if name.startswith(SPAN_PREFIX):
                        if s > span_start:
                            span, span_start = name[len(SPAN_PREFIX):], s
                    elif s > op_start:
                        op, op_start = name, s
            out.append([f"{span or 'harness'} / {op or 'python'}"[:120], b - a])
        return out


def profile(fn, cuda: bool = True):
    """(fn(), Trace) with host and (``cuda``) device activity recorded while
    fn runs; the card is synchronised before and after."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch_profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "traced"):
            t_host = time.perf_counter()
            out = fn()
            sync()
            window_s = time.perf_counter() - t_host
    device, host, t0 = [], [], None
    events = prof.profiler.kineto_results.events()
    # record_function ranges (the harness's and the program's own) also
    # appear on the device's timeline; they are spans, not device work.
    spans = {e.name() for e in events if e.is_user_annotation()}
    for e in events:
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.is_user_annotation() or name in spans):
                device.append((name, start, end))
        else:
            host.append((name, start, end))
            if name == SPAN_PREFIX + "traced":
                t0 = start
    t0 = t0 if t0 is not None else min((s for _, s, _ in host), default=0.0)
    return out, Trace(device, host, window_s, t0)


@contextlib.contextmanager
def patched(module, name, wrapper_factory):
    """Swap ``module.name`` for ``wrapper_factory(original)`` inside the
    block; the program calls its layers through module attributes."""
    real = getattr(module, name)
    wrapper = wrapper_factory(real)
    # Launch counters live on the function object (``fn.launches``) and the
    # program updates them through the module's name.
    wrapper.__dict__.update(real.__dict__)
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def spanned(label):
    """A wrapper factory that puts ``bench.<label>`` around each call."""
    import torch

    def factory(real):
        def wrapper(*a, **kw):
            with torch.profiler.record_function(SPAN_PREFIX + label):
                return real(*a, **kw)
        return wrapper
    return factory
