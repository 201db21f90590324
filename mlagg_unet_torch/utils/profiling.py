"""Device timing and trace reading on ``torch.profiler`` (counterpart of
``mlagg_unet_tpu/utils/profiling.py``, which reads ``jax.profiler`` traces).

A host clock around asynchronous CUDA work measures the enqueue, so these
helpers read the device's own records:

  * ``time_ms``: one call's CUDA-event time, the median of many, each call
    behind a device sleep so the stream waits while the host enqueues it;
  * ``device_events``: the device events of a ``torch.profiler`` trace summed
    by name, from the trace's raw events (``key_averages()`` builds an event
    tree first, which took most of a long trace's time), or through
    ``key_averages()`` where torch has no raw events;
  * ``device_time_ms`` and ``device_time_by_scope``: JAX's two functions,
    flat (top kernels) or grouped by the ``nn.Module`` path that launched
    each kernel.

Off the card (no device events) they return zero totals and empty lists,
as JAX's do off the TPU.

    from mlagg_unet_torch.utils.profiling import device_time_ms
    ms, top = device_time_ms(model, x, iters=3)
"""
from __future__ import annotations

import bisect
import collections
import statistics
from typing import Callable, List, Optional, Tuple

import torch

SLEEP_CYCLES = 2_000_000   # ~1 ms of SM clock ahead of each timed call
SCOPE_PREFIX = "scope::"   # the record_function ranges device_time_by_scope opens


def time_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 2) -> float:
    """Median over ``reps`` of one call's CUDA-event time. A device-side
    sleep of ~1 ms ahead of each call holds the stream while the host
    enqueues the call, so a short kernel's time is its own and not the
    host's launch overhead (which the GPU would otherwise idle through)."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _device_work(e) -> bool:
    """Whether a raw trace event is work on the card: a kernel, copy or
    memset, not the span a ``record_function`` range covers there (a GPU
    user annotation, which spans the gaps between its kernels too)."""
    from torch.autograd import DeviceType

    annotation = getattr(e, "is_user_annotation", None)
    return (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
            and not (annotation is not None and annotation()))


def device_events(prof) -> List[Tuple[str, float, int]]:
    """(name, device ms, count) of every device event name (kernels, copies,
    memsets) in a finished ``torch.profiler.profile``: the raw events summed
    by name, or ``key_averages()``'s device rows where torch lacks the
    private ``kineto_results``."""
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        return device_events_averaged(prof)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in raw.events():
        if _device_work(e):
            row = by_name[e.name()]
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    return [(k, t, c) for k, (t, c) in by_name.items()]


def device_events_averaged(prof) -> List[Tuple[str, float, int]]:
    """The same sums read through ``key_averages()``."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def trace(fn: Callable[[], object], iters: int = 1):
    """Run ``fn`` once untraced, then ``iters`` times under the profiler
    (CPU and, where there is a card, CUDA activity); returns the finished
    profile. On the card a trace can come back without any device record
    (seen in about half of the traces late in a long process): callers that
    need device time check for it."""
    from torch.profiler import profile

    fn()
    _sync()
    with profile(activities=_activities()) as prof:
        for _ in range(iters):
            fn()
        _sync()
    return prof


def device_time_ms(fn, *args, iters: int = 3, top_k: int = 10
                   ) -> Tuple[float, List[Tuple[str, float]]]:
    """Run ``fn(*args)`` ``iters`` times under the profiler; returns (device
    ms per iteration, [(kernel, ms per iteration)] of the ``top_k``
    longest)."""
    prof = trace(lambda: fn(*args), iters)
    dev = device_events(prof)
    total = sum(t for _, t, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:top_k]
    return total / iters, [(name, t / iters) for name, t, _ in top]


def _scope_hooks(module: torch.nn.Module):
    """Forward hooks that open a ``record_function`` range named
    ``scope::<module path>`` around every submodule's call; returns the hook
    handles."""
    open_ranges = collections.defaultdict(list)
    handles = []
    for name, mod in module.named_modules():
        label = SCOPE_PREFIX + (name or type(module).__name__)

        def pre(m, _args, label=label):
            rf = torch.autograd.profiler.record_function(label)
            rf.__enter__()
            open_ranges[id(m)].append(rf)

        def post(m, _args, _out):
            open_ranges[id(m)].pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return handles


def scope_ranges_and_launches(prof):
    """From a finished profile's raw events: the ``scope::`` ranges
    [(start ns, end ns, name)] and each device event's launch [(host ns of
    its launch, device ms, name)] (host ns -1 where no launch matched)."""
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        return [], []
    from torch.autograd import DeviceType

    ranges, launch_at, device = [], {}, []
    for e in raw.events():
        if e.device_type() == DeviceType.CUDA:
            if _device_work(e):
                device.append(e)
        elif e.name().startswith(SCOPE_PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.correlation_id():
            launch_at[e.correlation_id()] = e.start_ns()
    return ranges, [(launch_at.get(k.correlation_id(), -1), k.duration_ns() / 1e6, k.name())
                    for k in device]


def attribute_to_scopes(ranges, launches, depth: int):
    """Each launch to the innermost scope range around it on the host (the
    latest-starting range that contains its time): ``ranges`` [(start, end,
    'scope::a.b.c')], ``launches`` [(host time, device ms, kernel)]. Returns
    ({scope cut to ``depth`` parts: ms}, {unmatched kernel: ms})."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    by_scope = collections.Counter()
    unmatched = collections.Counter()
    for t, ms, kernel in launches:
        inner = next((ranges[i] for i in range(bisect.bisect_right(starts, t) - 1, -1, -1)
                      if ranges[i][1] >= t), None)
        if inner is None:
            unmatched[kernel] += ms
        else:
            path = inner[2][len(SCOPE_PREFIX):].split(".")
            by_scope[".".join(path[:depth])] += ms
    return by_scope, unmatched


def device_time_by_scope(fn, *args, module: Optional[torch.nn.Module] = None,
                         iters: int = 3, depth: int = 3, top_k: int = 30):
    """Device time grouped by the ``nn.Module`` path that launched each
    kernel (``module``, or ``fn`` itself when it is a module): returns
    (total ms per iteration, [(scope, ms)], [(unmatched kernel, ms)]). A
    kernel's scope is the innermost module whose forward was running on the
    host when it was launched, cut to its first ``depth`` path parts; a
    backward's kernels are unmatched."""
    module = module if module is not None else fn
    if not isinstance(module, torch.nn.Module):
        raise TypeError("device_time_by_scope needs the nn.Module whose scopes to read")
    handles = _scope_hooks(module)
    try:
        prof = trace(lambda: fn(*args), iters)
    finally:
        for h in handles:
            h.remove()
    ranges, launches = scope_ranges_and_launches(prof)
    by_scope, unmatched = attribute_to_scopes(ranges, launches, depth)
    total = sum(ms for _, ms, _ in launches)
    rows = [(s, ms / iters) for s, ms in by_scope.most_common(top_k)]
    un = [(s, ms / iters) for s, ms in unmatched.most_common(10)]
    return total / iters, rows, un
