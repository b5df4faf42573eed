"""Replay a fixed-shape function on the card as one CUDA graph.

The raw-scan preprocessing (`segmentation`, `features`) is a few hundred
small torch operations a sweep at fixed shapes, with nothing that waits
for the host: launched one by one, the host's launch time is several times
the device's work. `replay` captures such a function once per key and
input shapes, then copies each call's inputs into the captured buffers and
launches the graph. Off the card, or inside another capture, it calls the
function. The align loop (`core/svn.py`) keeps its state in the captured
buffers across several launches of one graph, through `capture` and
`launch`.
"""

from __future__ import annotations

from typing import Callable, Hashable, NamedTuple, Sequence

import torch

from svnicp_tpu_torch.kernels import _build

_GRAPHS: dict = {}


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static: list            # the captured inputs: copy into them, then launch
    out: list               # the captured outputs, overwritten by each launch
    launches: tuple         # (kernel wrapper, launches the graph holds)


def capture(key: Hashable, fn: Callable[..., Sequence[torch.Tensor]],
            *args: torch.Tensor, counted: Sequence = ()) -> tuple[Captured, bool]:
    """fn captured on the args' CUDA device once per key and the args'
    shapes, dtypes and device -> (the capture, whether this call made it).
    `key` names fn and every value it closes over. The static inputs start
    as copies of this call's args, and fn runs once on them before the
    capture. `counted`: kernel wrappers whose `.launches` each `launch`
    advances by the launches the graph holds (a launch does not run the
    wrappers); the capture and the run before it count none."""
    dev = args[0].device
    key = (key, dev, tuple((a.shape, a.dtype) for a in args))
    entry = _GRAPHS.get(key)
    if entry is not None:
        return entry, False
    static = [a.clone() for a in args]
    before = [w.launches for w in counted]
    # a first run on a side stream settles lazy initialisation and the
    # allocator before the capture, as torch.cuda.graphs requires
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream(dev).wait_stream(side)
    ran = [w.launches for w in counted]
    graph = torch.cuda.CUDAGraph()
    # thread_local: another thread's work on the card (a stage-ahead
    # upload) does not break the capture
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = list(fn(*static))
    held = []
    for w, b, r in zip(counted, before, ran):
        held.append((w, w.launches - r))
        _build.count_launch(w, b - w.launches)
    entry = _GRAPHS[key] = Captured(graph, static, out, tuple(held))
    return entry, True


def launch(entry: Captured) -> None:
    """Run the captured graph once on the current stream."""
    entry.graph.replay()
    for w, n in entry.launches:
        if n:
            _build.count_launch(w, n)


def replay(key: Hashable, fn: Callable[..., Sequence[torch.Tensor]],
           *args: torch.Tensor) -> list[torch.Tensor]:
    """fn(*args) -> its output tensors, in order. `key` names fn and every
    argument it closes over; the tensors' shapes, dtypes and device are
    added to it. On a CUDA device the outputs are copies: the next replay
    overwrites the captured ones."""
    dev = args[0].device
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return list(fn(*args))
    entry, _ = capture(key, fn, *args)
    for s, a in zip(entry.static, args):
        s.copy_(a)
    launch(entry)
    return [o.clone() for o in entry.out]
