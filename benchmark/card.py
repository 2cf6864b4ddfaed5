# Frozen copy of bench_torch.py:87-106 (``card``, commit 6cc3612).
"""The card's name and power limit."""

from __future__ import annotations

import subprocess

import torch


def card(device) -> dict:
    """The device's name and power limit: ``torch.cuda.get_device_name``
    and the limit ``nvidia-smi --query-gpu=name,power.limit`` reads."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    limit = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            limit = smi.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except OSError:
        pass
    return {"name": torch.cuda.get_device_name(index), "power_limit": limit}
