"""Power-of-two shape bucketing (a copy of the JAX package's
``utils/buckets.py``: the port keeps the reference's padded shapes so
its scheduler admits, windows and flushes exactly as the reference does).
"""

from __future__ import annotations

from typing import Optional


def bucket_size(
    n: int,
    minimum: int = 16,
    maximum: Optional[int] = None,
    dense: bool = False,
) -> int:
    """Smallest bucket >= n, floored at ``minimum``; clamped to
    ``maximum`` when given (callers must separately reject n > maximum if
    that is an error rather than a truncation point).

    ``dense=False``: powers of two — used for batch-shaped dims, where
    few compile variants matter more than padding waste.
    ``dense=True``: powers of two plus 3*2^k (… 256, 384, 512, 768,
    1024, 1536, 2048 …) — used for sequence lengths, where the padding
    waste is real FLOPs (a 1500-token RAG prompt pads to 1536, not 2048;
    every dense bucket stays a multiple of 128, which the Pallas decode
    kernel's KV tiling requires).
    """
    b = minimum
    while b < n and (maximum is None or b < maximum):
        # 3*2^k midpoints only from 384 up: below that they would not be
        # multiples of 128 (the decode kernel's KV tile requirement).
        if dense and b >= 256 and b * 3 // 2 >= n:
            b = b * 3 // 2
            break
        b *= 2
    return b if maximum is None else min(b, maximum)
