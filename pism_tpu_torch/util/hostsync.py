"""Host synchronisation points.

The JAX package keeps its loops on the device (``lax.while_loop`` /
``lax.cond``); the port decides them on the host. Every such decision reads
a device value through :func:`host`, which counts it in ``COUNT`` so a run
can report its host syncs per step (a diagnostic counter, like the kernel
wrappers' ``LAUNCHES``).
"""

from __future__ import annotations

COUNT = 0


def host(x):
    """Bring a 0-dim tensor (or a small tensor, as a list) to the host."""
    global COUNT
    COUNT += 1
    return x.item() if x.dim() == 0 else x.tolist()
