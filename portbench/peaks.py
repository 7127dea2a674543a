"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, at the full power limit of 700 W).  A roofline share is stated
against these, with the card's power limit beside it."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12},
}


def peak(device_kind: str, key: str) -> Optional[float]:
    """The peak ``key`` of the card named ``device_kind``, or None for a
    card the table does not hold."""
    for name, table in PEAKS.items():
        if name in device_kind:
            return table[key]
    return None


__all__ = ["PEAKS", "peak"]
