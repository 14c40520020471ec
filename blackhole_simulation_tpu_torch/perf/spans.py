"""Spans and counters of the port's requests, recorded while a torch
profiler session is active: the fused frame path and the inverse step.

A request's entry (``render``, an inverse step) asks once per call whether
a profiler session is active in its thread
(``torch.autograd._profiler_enabled``: true under
``torch.profiler.profile`` and under any session started through
``torch.autograd._enable_profiler``) and records that whole request or
none of it. No setting turns recording on, and nothing is written out:
the spans and counters stay in memory until ``reset()``. A request that is
not recorded costs each site one test of the flag ``on``.

A span is its name, its start and end on the Unix clock in nanoseconds
(``time.time_ns``, the clock on which Kineto stamps host events, so spans
line up with a device trace without conversion), the number of its
request (the field ``frame``: 0, 1, ... since the last ``reset``) and the
index in ``recorded()`` of the span it opened in (None for a request's
root). Spans of the fused frame path, each the whole call of a function
of ``render/pipeline.py``:

* ``frame``: ``render`` (a root);
* ``sample``: ``render_sample``, in ``frame``;
* ``host_row``: ``kernel_inputs``, the parameter row and ``RenderStatic``,
  in ``sample``;
* ``row_upload``: ``_upload_row``, the row's blocking copy to the device
  with the stream wait it makes, in ``host_row``.

Spans of an inverse step, the step of ``parallel/train.py``'s
``make_ad_inverse_step`` or ``make_inverse_step``:

* ``inverse_step``: the step's call (a root);
* ``inverse_forward``: the loss of the parameters (ray birth, precull,
  the march kernel, the composite, the loss), in ``inverse_step``;
* ``inverse_backward``: ``torch.autograd.grad`` of the loss (the gradient
  kernel, the composite's and the birth's backward, which autograd runs
  on its own thread while the step's thread waits in this span), in
  ``inverse_step``;
* ``adam``: ``_adam_update``, in ``inverse_step``.

Counter ``stream_syncs``: each point of a recorded request where the host
waits on the device, counted where the wait happens. In a frame: the row
upload on a CUDA device, ``_elementwise.host`` of a CUDA tensor (a scene
leaf held on the card) and ``models/nrs.nrs_flat_weights`` of CUDA
weights (the NRS far field's row block). In an inverse step, each blocking
copy between the host and the card: the mass's upload
(``parallel/train.py::_forward``), the camera's numbers where
``render/camera.py::camera_scalars`` makes them card tensors (not in a
step: the birth kernel takes them as launch arguments) and the precull's
critical-curve fit
(``render/precull.py``: mass and spin read back, the fit's five tensors
copied up). The staged and sharded paths record their ``frame`` and
``sample`` spans only, and their other waits are not counted.

One request is recorded at a time, in the thread that calls its entry;
the spans and counters of the autograd thread that a recorded step waits
for belong to that step.
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


on = False               # a request is being recorded
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


def root(name: str):
    """Decorate a request's entry: the call is the span ``name`` with no
    parent, and records the spans and counters inside it, when a profiler
    session is active in the calling thread and no request is being
    recorded."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            global on, _frames
            if on or not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            on = True
            _frames += 1
            _begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _end()
                on = False
        return call
    return wrap


frame = root("frame")


def span(name: str):
    """Decorate a function called inside a request: in a recorded request
    the call is the span ``name``, opened in the innermost open span."""
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
    so an unrecorded request pays one flag test."""
    _counts[name] = _counts.get(name, 0) + n


def recorded() -> list:
    """The spans recorded since the last ``reset``, in the order they
    opened."""
    return list(_spans)


def counters() -> dict:
    """The counters recorded since the last ``reset``."""
    return dict(_counts)


def reset() -> None:
    """Drop the spans and counters, and number requests from 0 again."""
    global _frames
    _spans.clear()
    _counts.clear()
    _frames = 0
