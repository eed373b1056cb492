"""The device a measurement ran on, for the records the scripts print."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


def smi_line(index: int = 0) -> Optional[str]:
    """Card ``index``'s line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (``"NVIDIA H100 80GB HBM3, 700.00 W"``), or
    None where ``nvidia-smi`` cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _power_limit_w(line: Optional[str]) -> Optional[float]:
    """The watts of an ``smi_line``, or None where it gives none."""
    try:
        return float(line.rsplit(",", 1)[1].split()[0])
    except (AttributeError, IndexError, ValueError):
        return None


def card_fields(device) -> dict:
    """``{"device", "power_limit_w"}``: the card's name and power limit in
    watts, or ``"cpu (host clock)"`` and None for a run on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu (host clock)", "power_limit_w": None}
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": _power_limit_w(smi_line(index))}
