"""CUDA graphs of work that holds hand kernels.

`Graph(fn, device, warm_up)` runs `warm_up()`, the same work as `fn()` on
scratch inputs, once on a side stream, so that what `fn` uses exists
before the capture (cuFFT plans, the cuBLAS handle and its workspace, the
hand kernels' libraries, constants uploaded at first use) and the
graph's outputs can take its outputs' shapes; then it captures the work
that `fn()` queues on the card as one CUDA graph and replays it once.
`replay()` runs it again: one launch on the current stream for all of its
kernels, on the same buffers. The graph copies the tensors that `fn()`
returns, at its end, into `out`: tensors of its own that each replay
overwrites. Unlike `torch.cuda.graph`, the capture neither collects
garbage nor empties the caching allocator, so that a module built once a
pass can afford one.

All graphs of a device are made on one side stream, one at a time, and
take the memory of their work from one pool. cuBLAS keeps a workspace for
each stream it has run on (32 MiB on an H100), so a stream for each graph
would hold a workspace each; and the caching allocator keeps a graph's own
pool reserved after the graph has gone, so a pool for each graph would
reserve the card's memory some tens of MiB at a time. In the shared pool a
graph's work reuses the memory of graphs gone before it, and of every
other graph's work; so graphs must run one at a time, as they do on one
stream. Every replay runs on its caller's current stream, the device's
default stream unless a caller sets another, and nothing but `out` (and
what `fn` writes in place) outlives a replay.

A replay launches the hand kernels that the capture recorded without
their wrappers, so the graph counts them for the wrappers. The capture's
own launches pass through `_build.Kernel` and add to their wrappers'
`launches` as any launch does, and the replay made at construction is the
one that runs them. Each later `replay()` passes each of its launches
through `Kernel` again, as `REPLAYED` so that nothing is launched twice,
and adds them to the wrappers' counts (`ops.cuda.count_launches`). So the
launches seen and counted are the kernels that the card runs.
"""

import threading
from typing import Callable

import torch

from satdump_tpu_torch.ops.cuda import _build, count_launches, launch_counts

_SIDE: dict = {}            # device: (the stream of its warm-ups and
_LOCK = threading.Lock()    #   captures, the graph that holds the pool)


def _side(dev: torch.device) -> tuple:
    """The side stream of a device's graphs, and a graph that holds their
    pool: PyTorch forgets a pool, on the card and on the host, when the
    last graph in it goes, and raises when a later capture names it. This
    one is never replayed; its kernel writes a tensor kept beside it."""
    side = torch.cuda.Stream(dev)
    keep = torch.zeros(1, device=dev)
    holder = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        holder.capture_begin(capture_error_mode="thread_local")
        keep.add_(1)
        holder.capture_end()
    return side, (holder, keep)


class Graph:
    def __init__(self, fn: Callable, device, warm_up: Callable):
        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        main = torch.cuda.current_stream(dev)
        self.graph = torch.cuda.CUDAGraph()
        with _LOCK, torch.cuda.device(dev):
            if dev not in _SIDE:
                _SIDE[dev] = _side(dev)
            side, (holder, _) = _SIDE[dev]
            side.wait_stream(main)
            with torch.cuda.stream(side):
                got = warm_up()
            # outside the pool, and made on the stream of the replays
            self.out = tuple(torch.empty_like(t) for t in got)
            del got
            side.wait_stream(main)
            self._capture(fn, side, holder.pool())
        main.wait_stream(side)
        self.graph.replay()

    def _capture(self, fn, side, pool) -> None:
        with torch.cuda.stream(side):
            side.synchronize()
            before = launch_counts()
            with _build.recording() as made:
                self.graph.capture_begin(pool,
                                         capture_error_mode="thread_local")
                try:
                    for dst, src in zip(self.out, fn()):
                        dst.copy_(src)
                finally:
                    self.graph.capture_end()
        self.launches = made
        self.counts = {k: n - before[k] for k, n in launch_counts().items()
                       if n != before[k]}

    def replay(self) -> None:
        """Run the captured work once more on the current stream."""
        self.graph.replay()
        for kernel, args in self.launches:
            kernel(_build.REPLAYED, *args)
        count_launches(self.counts)
