"""Observability: structured profiling, throughput counters, memory stats
(counterpart of ``climsim_tpu/utils/observability.py``).

The reference's tracing is ad hoc (wall timers, psutil RAM prints,
commented-out CUDA memory snapshots — SURVEY.md §5). Here the framework
exposes first-class hooks:

* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace JSON (the per-op host and device timeline) under a
  directory;
* :class:`Throughput` — rolling columns/s + step-time accounting with the
  compute/IO split the reference logs per report interval
  (rnn/utils.py:892,1592-1623);
* :func:`device_memory_stats` — live device memory per CUDA device;
* :class:`JsonlLogger` — the wandb replacement: structured per-step/epoch
  records to JSONL (reference metric names preserved by callers).
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["trace", "annotate", "host_memory_stats", "device_memory_stats",
           "Throughput", "JsonlLogger", "flop_analysis", "achieved_flops"]


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile a region: ``with trace('tb'): step()``. Records the host's
    operators, and the card's kernels when ``device`` (default: the card
    where there is one) is a CUDA device, and writes
    ``{logdir}/trace_<ms>.json`` (chrome://tracing, Perfetto) when the
    region ends. Yields the ``torch.profiler.profile``."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """Named trace annotation for profiler timelines."""
    return torch.profiler.record_function(name)


def host_memory_stats() -> dict:
    """Host RAM usage (the reference's psutil prints, training script
    :80-82)."""
    try:
        import psutil
        vm = psutil.virtual_memory()
        return {"total_gb": vm.total / 2**30, "used_gb": vm.used / 2**30,
                "percent": vm.percent}
    except ImportError:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"maxrss_gb": ru.ru_maxrss / 2**20}


def device_memory_stats() -> list[dict]:
    """One record a CUDA device (none without a card): the caching
    allocator's bytes in use and its peak, and the device's total memory
    (``torch.cuda.mem_get_info``)."""
    out = []
    for i in range(torch.cuda.device_count()):
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1]})
    return out


class Throughput:
    """Rolling throughput/step-time accounting.

    Mirrors the reference's per-report-interval timers with separate
    compute-time bookkeeping (rnn/utils.py:1592-1623)."""

    def __init__(self, report_every: int = 100):
        self.report_every = report_every
        self.reset()

    def reset(self):
        self.n_steps = 0
        self.n_items = 0
        self.compute_s = 0.0
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def step(self, items: int = 1):
        t = time.perf_counter()
        yield
        self.compute_s += time.perf_counter() - t
        self.n_steps += 1
        self.n_items += items

    @property
    def should_report(self) -> bool:
        return self.n_steps > 0 and self.n_steps % self.report_every == 0

    def report(self) -> dict:
        wall = time.perf_counter() - self.t0
        rec = {
            "steps": self.n_steps,
            "items_per_s": self.n_items / max(wall, 1e-9),
            "step_ms": 1e3 * wall / max(self.n_steps, 1),
            "compute_frac": self.compute_s / max(wall, 1e-9),
        }
        return rec


class JsonlLogger:
    """Append-only structured metric log (the wandb role,
    training script :925-977)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: dict, step: int | None = None):
        if step is not None:
            record = {"step": step, **record}
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def read(self) -> list[dict]:
        out = []
        try:
            with open(self.path) as f:
                for line in f:
                    out.append(json.loads(line))
        except FileNotFoundError:
            pass
        return out


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def flop_analysis(fn, *args, **kwargs) -> dict:
    """FLOPs of one call of ``fn`` on example args, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (products, convolutions
    and attention; 2 per multiply-add), with the bytes of the tensor
    arguments read once and the outputs written once, and their ratio,
    the arithmetic intensity: the roofline coordinates. The replacement
    for the reference's FLOP-calculation notebook.

    The JAX package asks XLA's cost analysis, which counts no Pallas
    kernel; FlopCounterMode counts no custom op (the ``climsim::``
    kernels), so both count the work outside the kernels. They differ on
    elementwise operations, which XLA counts and FlopCounterMode does
    not, and on bytes, which XLA counts for every operation. Returns {}
    when nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    if not flops:
        return {}
    byt = float(sum(t.numel() * t.element_size()
                    for t in _tensors(args) + _tensors(kwargs)
                    + _tensors(out)))
    res = {"flops": flops, "bytes_accessed": byt}
    if byt > 0:
        res["arithmetic_intensity"] = flops / byt
    return res


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def achieved_flops(fn, *args, peak_flops: float | None = None,
                   iters: int = 10, **kwargs) -> dict:
    """Measure achieved FLOP/s of ``fn`` (wall time over ``iters`` calls
    after a warm-up call, the card synchronised before and after) against
    :func:`flop_analysis`'s count; with ``peak_flops`` also reports the
    fraction of peak (MFU)."""
    cost = flop_analysis(fn, *args, **kwargs)
    with torch.no_grad():
        fn(*args, **kwargs)
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _sync()
    dt = (time.perf_counter() - t0) / iters
    res = {"seconds_per_call": dt, **cost}
    if cost.get("flops"):
        res["achieved_flops_per_s"] = cost["flops"] / dt
        if peak_flops:
            res["mfu"] = res["achieved_flops_per_s"] / peak_flops
    return res
