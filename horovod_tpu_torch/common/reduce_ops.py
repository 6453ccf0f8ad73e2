"""Reduction-op constants (parity: horovod/common/basics.py ReduceOp constants and
horovod/common/message.h:50-51 request op types)."""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Horovod-style module constants (torch/mpi_ops.py exposes these names).
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def handle_average_backwards_compatibility(op, average):
    """Mirror of horovod.common.util's op/average arg reconciliation: the legacy
    ``average=`` bool maps onto ``op=Average|Sum``; passing both is an error."""
    if op is not None and average is not None:
        raise ValueError("The op parameter supersedes average. Please provide only one "
                         "of them.")
    if op is not None:
        return ReduceOp(op)
    if average is not None:
        return Average if average else Sum
    return Average
