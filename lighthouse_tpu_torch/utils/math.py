"""Safe integer math helpers (reference consensus/safe_arith +
int_to_bytes: Python ints can't overflow, so the crate reduces to the spec
integer_squareroot and byte helpers).

The port's copy of lighthouse_tpu/utils/math.py."""

from __future__ import annotations


import math


def integer_squareroot(n: int) -> int:
    if n < 0:
        raise ValueError("negative input")
    return math.isqrt(n)


def int_to_bytes32_le(n: int) -> bytes:
    return n.to_bytes(32, "little")


def int_to_bytes8_le(n: int) -> bytes:
    return n.to_bytes(8, "little")
