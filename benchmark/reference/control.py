"""The step's branches for the reference: each predicate is read on the
host and only the taken side runs (one robot), as the port's CPU route."""

from __future__ import annotations


def _operands(operands):
    return operands[0] if len(operands) == 1 else tuple(operands)


def cond(pred, true_fn, false_fn, *operands):
    """`true_fn(*operands)` where `pred`, else `false_fn(*operands)`."""
    return (true_fn if bool(pred) else false_fn)(*operands)


def when(pred, fn, *operands):
    """`fn(*operands)` where `pred`, else the operands as they are."""
    return fn(*operands) if bool(pred) else _operands(operands)
