"""The card a run is on, as `nvidia-smi` names it."""

from __future__ import annotations

import subprocess


def card_lines() -> str:
    """`name, power.limit` of each GPU, joined by ' | '. Raises where
    `nvidia-smi` is missing or fails: a GPU result must name its card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())
