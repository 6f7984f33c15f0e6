"""Host staging of the sessions: pinned copies on side streams, and the
clock of one frame.

A session on CUDA moves its frames through page-locked host memory: an
upload copies the host array into a pinned block (PyTorch's caching host
allocator hands out and recycles the blocks) and from there to the card
on the session's upload stream; a download copies a device tensor into a
fresh pinned block on the download stream.  Neither blocks the host, and
neither waits for work of the compute stream (the current stream, where
the kernels launch) that it does not need: an upload is ordered before
the compute stream's next work by a stream wait, a download after the
event it is given (the end of its frame's kernels), so that frame i's
copy back does not wait for frame i+1's kernels queued after it.  Tensors
crossing streams are kept alive for the stream that reads them
(``record_stream``).  On the CPU every copy is the tensor itself and the
clock reads the host's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch


class Clock:
    """The timeline of one frame: phases on the compute stream, each
    lasting from its mark to the next, and named points of the copies on
    the side streams; CUDA timing events on a card, the host's clock on
    the CPU.  Nothing is read until the frame's result has been waited
    for, so a clock adds no synchronisation."""

    def __init__(self, device: torch.device) -> None:
        self._cuda = device.type == "cuda"
        self.marks: List[Tuple[str, object]] = []
        self.points: Dict[str, object] = {}

    def _now(self, stream=None):
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def mark(self, phase: str) -> None:
        """Open phase `phase` on the current stream (an "end" mark closes
        the last one)."""
        self.marks.append((phase, self._now()))

    def point(self, name: str, stream=None) -> None:
        self.points[name] = self._now(stream)

    def _ms(self, a, b) -> float:
        if not self._cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)

    def ms(self, a: str, b: str) -> float:
        """Milliseconds from point a to point b; 0 when either is
        missing."""
        if a not in self.points or b not in self.points:
            return 0.0
        return self._ms(self.points[a], self.points[b])

    def span(self) -> float:
        """Milliseconds from the first mark to the last."""
        if len(self.marks) < 2:
            return 0.0
        return self._ms(self.marks[0][1], self.marks[-1][1])

    def phases(self) -> Dict[str, float]:
        """Milliseconds of each phase, summed over its marks."""
        out: Dict[str, float] = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + self._ms(a, b)
        return out


class Fetch:
    """A tensor on its way to the host: get() waits for its copy."""

    def __init__(self, tensor: torch.Tensor, done=None) -> None:
        self.tensor = tensor
        self.done = done

    def get(self) -> torch.Tensor:
        if self.done is not None:
            self.done.synchronize()
            self.done = None
        return self.tensor


class Staging:
    """The upload and download streams of a session's device (none on the
    CPU) and the copies that go through them."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        cuda = device.type == "cuda"
        self.up = torch.cuda.Stream(device) if cuda else None
        self.down = torch.cuda.Stream(device) if cuda else None

    def event(self):
        """An event recorded now on the current stream (None on the
        CPU)."""
        if self.up is None:
            return None
        return torch.cuda.current_stream(self.device).record_event()

    def pinned(self, h: torch.Tensor) -> torch.Tensor:
        """h where an upload reads it without blocking: on CUDA a host
        tensor outside pinned memory is copied into a pinned block;
        anything else is returned as it is."""
        if self.up is None or h.device.type != "cpu" or h.is_pinned():
            return h
        return torch.empty(h.shape, dtype=h.dtype,
                           pin_memory=True).copy_(h)

    def upload(self, *hosts: torch.Tensor, clock: Optional[Clock] = None):
        """(the host tensors on the session's device, usable on the current
        stream; the event after their copies, None on the CPU).  A host
        tensor outside pinned memory is copied into a pinned block first;
        the copies run on the upload stream between the clock's points
        "up0" and "up1".  A tensor already on the device is returned as it
        is."""
        if self.up is None or all(h.device.type != "cpu" for h in hosts):
            return [h.to(self.device) for h in hosts], None
        hosts = [self.pinned(h) for h in hosts]
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.up):
            if clock is not None:
                clock.point("up0", self.up)
            outs = [h.to(self.device, non_blocking=True) for h in hosts]
            if clock is not None:
                clock.point("up1", self.up)
            done = self.up.record_event()
        cur.wait_stream(self.up)
        for o in outs:
            o.record_stream(cur)
        return outs, done

    def download(self, t: torch.Tensor, after=None,
                 clock: Optional[Clock] = None,
                 points: Tuple[str, str] = ("d0", "d1"),
                 out: Optional[torch.Tensor] = None) -> Fetch:
        """Copy device tensor t into a fresh pinned block (or into `out`,
        a pinned host tensor of t's shape) on the download stream once
        event `after` (default: everything queued on the current stream
        so far) has passed; the clock's points bracket the copy.  On the
        CPU the fetch is t itself, or out holding t's values."""
        if self.down is None:
            return Fetch(t if out is None else out.copy_(t))
        if out is None:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if after is None:
            after = self.event()
        self.down.wait_event(after)
        with torch.cuda.stream(self.down):
            if clock is not None:
                clock.point(points[0], self.down)
            out.copy_(t, non_blocking=True)
            if clock is not None:
                clock.point(points[1], self.down)
            done = self.down.record_event()
        t.record_stream(self.down)
        return Fetch(out, done)
