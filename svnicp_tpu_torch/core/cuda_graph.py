"""Replay a fixed-shape function on the card as one CUDA graph.

The raw-scan preprocessing (`segmentation`, `features`) is a few hundred
small torch operations a sweep at fixed shapes, with nothing that waits
for the host: launched one by one, the host's launch time is several times
the device's work. `replay` captures such a function once per key and
input shapes, then copies each call's inputs into the captured buffers and
launches the graph. Off the card, or inside another capture, it calls the
function.
"""

from __future__ import annotations

from typing import Callable, Hashable, Sequence

import torch

_GRAPHS: dict = {}


def replay(key: Hashable, fn: Callable[..., Sequence[torch.Tensor]],
           *args: torch.Tensor) -> list[torch.Tensor]:
    """fn(*args) -> its output tensors, in order. `key` names fn and every
    argument it closes over; the tensors' shapes, dtypes and device are
    added to it. On a CUDA device the outputs are copies: the next replay
    overwrites the captured ones."""
    dev = args[0].device
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return list(fn(*args))
    key = (key, dev, tuple((a.shape, a.dtype) for a in args))
    entry = _GRAPHS.get(key)
    if entry is None:
        static = [a.clone() for a in args]
        # a first run on a side stream settles lazy initialisation and the
        # allocator before the capture, as torch.cuda.graphs requires
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = list(fn(*static))
        entry = _GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    for s, a in zip(static, args):
        s.copy_(a)
    graph.replay()
    return [o.clone() for o in out]
