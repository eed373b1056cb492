"""The flags every example takes, and the device they select."""

from __future__ import annotations

import argparse

import torch

from ..utils.device import resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    """A parser with the flags every example takes."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--quick", action="store_true",
                   help="shrink the scene for a fast smoke run")
    return p


def device_of(args) -> torch.device:
    """``--cpu`` → the CPU, else the card (raising without one); printed."""
    device = torch.device(resolve_device("cpu" if args.cpu else None))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    return device


def parse(doc: str, argv=None):
    """``(args, device)`` for an example that takes only the common flags."""
    args = parser(doc).parse_args(argv)
    return args, device_of(args)
