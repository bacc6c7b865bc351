"""The card's published peaks and what the machine says of its card.

NVIDIA H100 SXM (data sheet, dense, no sparsity, at the full 700 W power
limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM.  Every share of a peak is printed with the
card's power limit beside it, since a card set below 700 W runs slower.
"""
from __future__ import annotations

import subprocess

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "power_limit"]

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reads them,
    or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "unknown"
