"""One CUDA graph for a map of fixed-shape tensors.

The Blatter and SSAFEM Krylov loops apply the same linearized operator and
preconditioner hundreds of times a Newton sweep, each call hundreds of
small elementwise launches whose host time exceeds their device time at
the ISMIP-HOM sizes. :func:`graphed` captures
such a map once a sweep and replays it: the inputs are copied into the
captured buffers, the graph is launched, and the outputs are cloned out.
The kernels and their order are those of the plain calls, so the results
are the same bits.

On a CPU tensor, or with ``ENABLED`` False, ``graphed`` returns the map
itself.
"""

from __future__ import annotations

import torch

#: capture on the card (False runs the plain calls, for timing against)
ENABLED = True
#: graphs captured since import (a count for the tests and the smoke run)
CAPTURES = 0


def graphed(fn, *example):
    """``fn`` (tensors -> tuple of tensors, no host syncs, no host-to-card
    copies after its first call) as a replay of one graph captured at the
    shapes and devices of ``example``."""
    global CAPTURES
    if not ENABLED or not example[0].is_cuda:
        return fn
    static = [x.clone() for x in example]
    main = torch.cuda.current_stream(example[0].device)
    side = torch.cuda.Stream(device=example[0].device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn(*static)       # the first call: allocations, cached indices
        # capture_begin/end, not the torch.cuda.graph context, which
        # synchronizes and empties the allocator's cache at every capture
        graph.capture_begin()
        try:
            out = fn(*static)
        finally:
            graph.capture_end()
    main.wait_stream(side)
    CAPTURES += 1

    def replay(*xs):
        for s, x in zip(static, xs):
            s.copy_(x)
        graph.replay()
        return tuple(o.clone() for o in out)

    # the graph reads the tensors fn closes over: they live as long as it
    replay.fn = fn
    return replay
