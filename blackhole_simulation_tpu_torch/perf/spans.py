"""Spans and counters of the fused frame path, recorded while a torch
profiler session is active.

``render`` asks once per call whether a profiler session is active in its
thread (``torch.autograd._profiler_enabled``: true under
``torch.profiler.profile`` and under any session started through
``torch.autograd._enable_profiler``) and records that whole frame or none
of it. No setting turns recording on, and nothing is written out: the
spans and counters stay in memory until ``reset()``. A frame that is not
recorded costs each site one test of the flag ``on``.

A span is its name, its start and end on the Unix clock in nanoseconds
(``time.time_ns``, the clock on which Kineto stamps host events, so spans
line up with a device trace without conversion), the number of its frame
(the request id: 0, 1, ... since the last ``reset``) and the index in
``recorded()`` of the span it opened in (None for a frame). Spans of the
fused path, each the whole call of a function of ``render/pipeline.py``:

* ``frame``: ``render`` (no parent);
* ``sample``: ``render_sample``, in ``frame``;
* ``host_row``: ``kernel_inputs``, the parameter row and ``RenderStatic``,
  in ``sample``;
* ``row_upload``: ``_upload_row``, the row's blocking copy to the device
  with the stream wait it makes, in ``host_row``.

Counter ``stream_syncs``: each point of a recorded frame where the host
waits on the device, counted where the wait happens: the row upload on a
CUDA device, ``_elementwise.host`` of a CUDA tensor (a scene leaf held on
the card) and ``models/nrs.nrs_flat_weights`` of CUDA weights (the NRS
far field's row block). The staged, sharded and inverse paths record
their ``frame`` and ``sample`` spans only, and their other waits are not
counted.

Counter ``tonemap_kernel``: each call of ``ops/tonemap.py::tonemap_kernel``
in a recorded frame, counted once its launch succeeds (one a frame on the
card; the CPU's plain path counts none).

One frame is recorded at a time, in the thread that renders: the port
renders from one thread.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int          # 0 while the span is open
    frame: int
    parent: int | None   # index in recorded() of the enclosing span


on = False               # a frame is being recorded
_spans: list = []
_counts: dict = {}
_open: list = []         # indices of the open spans, innermost last
_frames = 0


def _begin(name: str) -> None:
    _spans.append(Span(name, time.time_ns(), 0, _frames - 1,
                       _open[-1] if _open else None))
    _open.append(len(_spans) - 1)


def _end() -> None:
    i = _open.pop()
    _spans[i] = _spans[i]._replace(end_ns=time.time_ns())


def frame(fn):
    """Decorate the frame's entry: the call is the span ``frame``, and
    records the spans and counters inside it, when a profiler session is
    active in the calling thread and no frame is being recorded."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        global on, _frames
        if on or not torch.autograd._profiler_enabled():
            return fn(*args, **kwargs)
        on = True
        _frames += 1
        _begin("frame")
        try:
            return fn(*args, **kwargs)
        finally:
            _end()
            on = False
    return call


def span(name: str):
    """Decorate a function called inside a frame: in a recorded frame the
    call is the span ``name``, opened in the innermost open span."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not on:
                return fn(*args, **kwargs)
            _begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _end()
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``. Callers count only while ``on``,
    so an unrecorded frame pays one flag test."""
    _counts[name] = _counts.get(name, 0) + n


def recorded() -> list:
    """The spans recorded since the last ``reset``, in the order they
    opened."""
    return list(_spans)


def counters() -> dict:
    """The counters recorded since the last ``reset``."""
    return dict(_counts)


def reset() -> None:
    """Drop the spans and counters, and number frames from 0 again."""
    global _frames
    _spans.clear()
    _counts.clear()
    _frames = 0
