"""Spans of the port: the host and device time, and the kernel launches, of
each stage of a step.

A span names a stretch of the program::

    from gemini_seal_tpu_torch import tracing

    @tracing.span("keyswitch.modup")
    def compute_modup_digits(...): ...

    with tracing.span("behz.floor"):
        ...

The spans the port carries, where they are, and the benchmark's per-layer
metric that reads each (``benchmark/metrics/<metric>.py``, a mean over the
step spans of the traced window):

==============================  =====================================  =================
span                            where                                  metric
==============================  =====================================  =================
``step.ckks_mul_relin_rescale`` the step of build_ckks_mul_relin_      ``step_device_ms``,
``step.bfv_mul_relin``          rescale, build_bfv_mul_relin and       ``step_host_ms``
``step.rotate_many``            both rotate-many builders
``keyswitch.modup``             compute_modup_digits                   ``modup_ms``
``keyswitch.inner_product``     the key contraction: keyswitch_inner_  ``inner_product_ms``
                                product without its mod-down, batched_
                                rotated_inner_product with its digit
                                permutation, keys_stack_inner_product,
                                _shared_digit_inner_product
``keyswitch.moddown``           rescale_special, fused_moddown         ``moddown_ms``
``rns.rescale``                 divide_and_round_q_last(_ntt)          ``rescale_ms``
``behz.extend``, ``behz.floor`` build_bfv_mul_relin's lifts to q and   ``behz_ms``
                                Bsk; its inverse transforms, the
                                multiply by t, fast_floor, fastbconv_sk
``gst_exchange``                a ThreadGroup's exchange copies        chip_smoke.py's
                                (parallel/comm.py)                     ``exchange_copies``
==============================  =====================================  =================

Stage spans do not nest in one another, so each stretch of a step's device
time lies in at most one stage; the rest of a step (its tensor product, adds,
stacks and output permutation) is the step span's own time.  A span entered
inside a span of the same name on the same thread counts once (the outer).

The counter: ``ops.cuda.call`` raises a running count of the launches of
hand-written kernels on the calling thread (``cuda.thread_launches``); a
span's ``launches`` are those made inside it.  On the CPU the plain
versions launch nothing, and read 0.

Tracing is on while a torch.profiler session records on the process, or
between ``enable()`` and ``disable()``; nothing else switches it.  Off, a
span is one flag test: no ``record_function``, no clock read, no event.  On,
a span enters ``torch.profiler.record_function(name)`` (so it lands in the
profiler's trace on the clock of the device events, nested in the caller's
ranges), reads the host clock at entry and exit, records a CUDA timing event
on the current stream at entry and exit where the process has initialised
CUDA (on the CPU a span's device time is its host time: the plain versions
run synchronously), and counts the launches made inside it.  The events come
from a pool and are resolved only by ``summary()``: no span synchronizes.

The record holds, for each span name, the count, host seconds, device
seconds, launches and the names of the spans it ran in (each thread keeps
its own stack: the ranks of a ThreadGroup do not mix).  It holds one
session: the first span that finds tracing on starts a fresh record once
the last one was closed, by ``reset()``, ``enable()``, ``disable()`` or a
``summary()`` read while tracing is off.  So a reader after a profiler
session sees that session and nothing that ran before it.

Without a profiler, an operator runs::

    tracing.enable()
    for args in batches:
        step(*args)
    tracing.disable()
    print(tracing.summary())
"""

from __future__ import annotations

import functools
import threading
import time

import torch
from torch.autograd import profiler as _prof

__all__ = ["span", "enable", "disable", "is_on", "summary", "reset"]

_enabled = False          # enable() .. disable()
_open_frames = 0          # spans entered while on and not yet left, every thread
_session_open = False     # the record belongs to a session still being added to
_use_events = False       # this session records CUDA timing events
_lock = threading.Lock()
_local = threading.local()
_record = {}              # name -> [count, host_s, device_s, launches, parents]
_pending = []             # (name, start event, end event), resolved by summary()
_pool = []                # free CUDA timing events
_cuda = None              # ops.cuda, bound at the first session


def is_on() -> bool:
    """Whether spans record: a torch.profiler session or enable()."""
    return _prof._is_profiler_enabled or _enabled


class span:
    """A named span: ``with span(name):`` or ``@span(name)``.

    The object holds only its name; what one entry recorded lives on the
    entering thread's stack, so one span object serves every thread."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _prof._is_profiler_enabled or _enabled:
            _enter(self)
        return self

    def __exit__(self, *exc):
        if _open_frames:
            _exit(self)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if _prof._is_profiler_enabled or _enabled:
                with self:
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return traced


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _fresh() -> None:
    """Start a new record (under _lock)."""
    global _session_open, _use_events, _cuda
    if _cuda is None:
        from .ops import cuda as _c
        _cuda = _c
    _record.clear()
    _pending.clear()
    _use_events = torch.cuda.is_available() and torch.cuda.is_initialized()
    _session_open = True


def _event():
    ev = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _enter(sp: span) -> None:
    global _open_frames
    stack = _stack()
    with _lock:
        if not _session_open:
            _fresh()
        _open_frames += 1
    if any(f[0].name == sp.name for f in stack if f[1] is not None):
        stack.append((sp, None))        # nested in its own name: counts once
        return
    parent = next((f[0].name for f in reversed(stack) if f[1] is not None), None)
    rf = _prof.record_function(sp.name)
    rf.__enter__()
    launches = _cuda.thread_launches()
    ev = _event() if _use_events else None
    stack.append((sp, (parent, rf, launches, ev, time.perf_counter())))


def _exit(sp: span) -> None:
    global _open_frames
    stack = getattr(_local, "stack", None)
    if not stack or stack[-1][0] is not sp:
        return                          # entered while tracing was off
    _, frame = stack.pop()
    if frame is not None:
        parent, rf, launches0, ev0, t0 = frame
        host = time.perf_counter() - t0
        ev1 = _event() if ev0 is not None else None
        launches = _cuda.thread_launches() - launches0
        rf.__exit__(None, None, None)
    with _lock:
        _open_frames -= 1
        if frame is None:
            return
        rec = _record.get(sp.name)
        if rec is None:
            rec = _record[sp.name] = [0, 0.0, 0.0, 0, set()]
        rec[0] += 1
        rec[1] += host
        rec[3] += launches
        if parent is not None:
            rec[4].add(parent)
        if ev0 is None:
            rec[2] += host
        else:
            _pending.append((sp.name, ev0, ev1))


def summary() -> dict:
    """The record: name -> {"count", "host_s", "device_s", "launches",
    "parents"}.  Resolves the CUDA events still pending (waiting for them);
    read while tracing is off, it closes the session, so that the next span
    to find tracing on starts a fresh record."""
    global _session_open
    with _lock:
        pending = list(_pending)
        _pending.clear()
    for name, ev0, ev1 in pending:
        ev1.synchronize()
        device = ev0.elapsed_time(ev1) * 1e-3
        with _lock:
            if name in _record:
                _record[name][2] += device
            _pool.extend((ev0, ev1))
    with _lock:
        if not is_on():
            _session_open = False
        return {name: {"count": r[0], "host_s": r[1], "device_s": r[2], "launches": r[3],
                       "parents": sorted(r[4])} for name, r in _record.items()}


def reset() -> None:
    """Clear the record; the next span to find tracing on starts a new one."""
    global _session_open
    with _lock:
        _record.clear()
        _pending.clear()
        _session_open = False


def enable() -> None:
    """Turn spans on without a profiler, with a fresh record."""
    global _enabled
    reset()
    _enabled = True


def disable() -> None:
    """Turn enable() off; the record stays for summary()."""
    global _enabled, _session_open
    _enabled = False
    with _lock:
        _session_open = False
