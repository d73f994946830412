"""The model kernels' work on the meta device, for the dry run
(``launch/dryrun.py``).

Handed meta tensors, a kernel wrapper (and its autograd Function) returns
outputs of the kernel's shapes and types without computing anything, and
adds here what the kernel's bound in PERF.md §6 reckons: its operations,
and its bytes with each input read once and each output written once.  It
never runs the plain version, which would count work the kernel does not
do (the plain attention's materialised score matrix).

``COUNTS["flops"]`` and ``COUNTS["bytes"]`` sum every call since
:func:`reset`; ``CALLS`` counts the calls by kernel name (a backward's
name ends in ``_bwd``).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, Optional

import torch

COUNTS: Dict[str, float] = {"flops": 0.0, "bytes": 0.0}
CALLS: Counter = Counter()


def reset() -> None:
    COUNTS["flops"] = 0.0
    COUNTS["bytes"] = 0.0
    CALLS.clear()


def nbytes(tensors: Iterable[Optional[torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors  # repro: noqa DET004 -- byte counts are ints; integer addition is order-independent
               if t is not None)


def account(name: str, flops: float, ins, outs) -> None:
    """One call of kernel ``name``: ``flops`` operations, the bytes of the
    tensors ``ins`` read and ``outs`` written."""
    COUNTS["flops"] += float(flops)
    COUNTS["bytes"] += float(nbytes(ins) + nbytes(outs))
    CALLS[name] += 1
