"""Operations of a model's dense layers, counted from their shapes: what
each model's counts (`counts/<model>.py`) add up."""
from __future__ import annotations


def chain_flops(rows: int, chans) -> int:
    """Operations of one Dense chain over `rows` rows (2 a multiply-add):
    chip_smoke.py's `chain_flops`."""
    return 2 * rows * sum(a * b for a, b in zip(chans[:-1], chans[1:]))
