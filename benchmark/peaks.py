"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
H100 SXM, dense, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Optional

H100 = {"fp32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}


def peak(kind: str, what: str) -> Optional[float]:
    """The peak ``what`` of the card named ``kind``; None for a card not in
    the table."""
    return H100[what] if "H100" in kind else None
