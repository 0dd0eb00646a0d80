"""Model-FLOP accounting for the benchmarks (MFU reporting).

Counterpart of the JAX package's ``utils/flops.py``.  ``dot_flops(fn,
*args, **kwargs)`` runs ``fn`` once under
``torch.utils.flop_counter.FlopCounterMode`` and returns the JAX package's
keys:

- ``model``: the network's products, the ``mm`` / ``addmm`` / ``bmm`` /
  convolution / attention ops the counter knows, forward and backward where
  ``fn`` runs a backward, at 2 FLOPs a multiply-add;
- ``gather``: always 0.  The JAX package classes as ``gather`` the one-hot
  contractions that encode a neighbour gather on the TPU's matrix unit
  (``ops/sampling.py`` there); in the port a gather is an indexed load;
- ``pallas``: 2 x the multiply-adds hand-written kernels compute in their
  bodies, which the counter cannot see (a ``ctypes`` launch dispatches no
  PyTorch op).  Their wrappers record them with ``record_pallas_macs``,
  which is a no-op outside a ``pallas_flops_tally`` scope.  The only kernel
  with products in its body is the fused attention pool (#7,
  ``ops/attention_pool.py``): when its sweeps run, its wrapper records the
  multiply-adds the unfused pool computes with ``matmul`` and the sweeps
  take over (``attention_pool_kernel_macs``), so ``model + pallas`` of a
  step is the same with ``fused_attention`` on or off.

The TPU kernels' structural multiply-adds (the rank matmul of the windowed
ball group, ``ops/pallas_window.py:979-985`` in the JAX package, and its
twins) have no counterpart: the port's kernels scan and gather without
products, and record nothing.

``H100_BF16_PEAK_FLOPS`` is the dense bf16 rate of one H100 SXM at its
700 W limit (NVIDIA's data sheet), in place of the JAX package's v5e rate.
"""

from __future__ import annotations

import contextlib
from typing import Callable

from torch.utils.flop_counter import FlopCounterMode

H100_BF16_PEAK_FLOPS = 989e12  # one card, dense

# the multiply-adds the kernel wrappers record; recording is a no-op unless
# a pallas_flops_tally scope is open, so ordinary runs do not grow the list
_PALLAS_TALLY: list = []
_TALLY_DEPTH: int = 0


def record_pallas_macs(macs: float) -> None:
    if _TALLY_DEPTH > 0:
        _PALLAS_TALLY.append(float(macs))


@contextlib.contextmanager
def pallas_flops_tally():
    """Scope a run; yields a dict whose ``flops`` is filled on exit with 2 x
    the in-kernel multiply-adds recorded during the scope."""
    global _TALLY_DEPTH
    start = len(_PALLAS_TALLY)
    out = {}
    _TALLY_DEPTH += 1
    try:
        yield out
    finally:
        _TALLY_DEPTH -= 1
        out["flops"] = 2.0 * sum(_PALLAS_TALLY[start:])
        del _PALLAS_TALLY[start:]


def dot_flops(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return {'model': flops,
    'gather': 0.0, 'pallas': flops}.  Apply it to one step: what ``fn``
    runs is what is counted."""
    with pallas_flops_tally() as tally, FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"model": float(counter.get_total_flops()), "gather": 0.0,
            "pallas": tally["flops"]}
