"""Which accelerator a measurement ran on.

Every number a measuring entry point prints (``bench.py``,
``chip_smoke.py``) names its device: JAX's platform, device kind and
count, and the card's name and power limit, which ``nvidia-smi`` reads in
a child process that does not touch JAX.  A measuring entry point that
finds no GPU stops; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
import sys


def require_gpu(devices):
    """``devices`` when its first device is a GPU, else SystemExit(2)."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        print(f"no GPU found (JAX platform: {found})", file=sys.stderr)
        raise SystemExit(2)
    return devices


def parse_smi(text: str) -> list[tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> [(name, power limit)], one per card."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def query_cards() -> list[tuple[str, str]]:
    """Name and power limit of every card, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    cards = parse_smi(out)
    if not cards:
        raise RuntimeError("nvidia-smi listed no card")
    return cards
