"""CUDA graphs of one FedAvg round, for the fused multi-round driver.

``FusedRounds`` (algorithms/fedavg.py) runs R rounds per dispatch, the
counterpart of the JAX package's ``lax.scan`` over rounds. On a CUDA device
it captures the round's device work once with ``torch.cuda.graph`` and
replays it R times: the host fills the graph's static input buffers on the
device and replays, with no synchronization and no host read between
replays. The round writes its new model into the static carry buffers
inside the graph, so replay r + 1 starts from round r's model.

As the PyTorch CUDA-graph notes prescribe, the round runs once eagerly on
a side stream before the capture (cuDNN picks its algorithms there, and
the kernels' libraries load), and the capture then records the same
launches. A capture that fails raises; nothing falls back to eager rounds.

The package's own kernels count their launches in their Python wrappers,
which a replay does not run, and which a capture runs without launching
anything. :class:`CapturedRound` records how many launches of each
counted wrapper its capture recorded, puts the counts back to their
values from before the capture, and adds the recorded launches at every
replay, so the counts stay the number of times each kernel ran: the
warm-up's launches and the replays', never the capture's.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Sequence

import torch


def counted_kernels() -> tuple:
    """The wrappers that count their launches (``fn.launches``)."""
    from fedml_tpu_torch.ops import aggregate, flash_attention, quantize
    return (aggregate.weighted_mean_flat, flash_attention.flash_fwd,
            flash_attention.flash_bwd_dkdv, flash_attention.flash_bwd_dq,
            quantize.quantize_int8, quantize.dequantize_int8)


class CapturedRound:
    """``fn(*inputs) -> (new_carry, outputs)`` captured once.

    ``inputs`` are the static buffers the caller fills before each
    :meth:`replay`; ``carry`` are static buffers that ``new_carry`` (a
    list of tensors of the same shapes) is copied into at the end of the
    graph. ``outputs`` (any nest of tensors) live in the graph's private
    memory pool and are overwritten by the next replay."""

    #: captures made in this process (each also ran one warm-up round)
    captures = 0

    def __init__(self, fn: Callable, inputs: Sequence,
                 carry: List[torch.Tensor]):
        self.inputs, self.carry = inputs, carry
        # one warm-up round on a side stream, off the capture: it reads the
        # static buffers and discards what it computes
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        kernels = counted_kernels()
        before = [k.launches for k in kernels]
        # the capture empties the allocator's cache as it begins; empty it
        # first, so that the growth of the reserved bytes is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a cohort-prefetch worker of the host loop may still
        # be copying on its own thread; only this thread's calls are barred
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            new_carry, self.outputs = fn(*inputs)
            for dst, src in zip(carry, new_carry):
                dst.copy_(src)
        torch.cuda.synchronize()
        #: host seconds the capture took, and the bytes its pool reserved
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        #: launches of each counted wrapper that one replay makes; the
        #: capture itself launched nothing, so its counts are taken back
        self.launches: Dict[Callable, int] = {
            k: k.launches - b for k, b in zip(kernels, before)
            if k.launches != b}
        for k, b in zip(kernels, before):
            k.launches = b
        self.replays = 0
        CapturedRound.captures += 1

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for k, n in self.launches.items():
            k.launches += n


class GraphCache:
    """Captured rounds by shape key, least recently used first out (each
    graph holds a private memory pool, so the cache is bounded)."""

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key, build: Callable[[], CapturedRound]) -> CapturedRound:
        if key in self._graphs:
            self._graphs.move_to_end(key)
            return self._graphs[key]
        while len(self._graphs) >= self.capacity:
            self._graphs.popitem(last=False)
        self._graphs[key] = graph = build()
        return graph

    def __len__(self) -> int:
        return len(self._graphs)

    def values(self):
        return list(self._graphs.values())
