"""Host synchronisation points.

The JAX package keeps its loops on the device (``lax.while_loop`` /
``lax.cond``); the port decides them on the host. Every such decision reads
a device value through :func:`host`, which counts it in ``COUNT`` so a run
can report its host syncs per step (a diagnostic counter, like the kernel
wrappers' ``LAUNCHES``).
"""

from __future__ import annotations

COUNT = 0
#: sweeps between the change checks of ``fixed_point``
CHECK_EVERY = 8


def host(x):
    """Bring a 0-dim tensor (or a small tensor, as a list) to the host."""
    global COUNT
    COUNT += 1
    return x.item() if x.dim() == 0 else x.tolist()


def fixed_point(step, x, max_iters):
    """``step`` applied until ``x`` stops changing or ``max_iters`` sweeps
    have run: the port of a ``lax.while_loop`` that tests for change after
    every sweep. Change is read once per ``CHECK_EVERY`` sweeps; the sweeps
    run after convergence change nothing, so the result is the same."""
    import torch

    it = 0
    while it < max_iters:
        before = x
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            x = step(x)
            it += 1
        if not host(torch.any(x != before)):
            break
    return x
