"""Ouster OS1-16 LiDAR ingestion: raw packet bytes → Cartesian cloud.

Counterpart of ``fpcr_tpu/data/ouster.py``, the reference's hall-scan
ingest. The packet walk is numpy gather arithmetic on the file's byte
values: the initial encoder count comes from lines 13/14 of the first packet
(lo | hi<<8), and each range is a 20-bit word reassembled from 3 bytes at
line ``17 + 12*channel + 788*block + 12608*packet`` for channels 2, 6, ...,
62. The polar→Cartesian conversion runs in torch on the requested device:
per return i, azimuth block i//16 and channel i%16; encoder counter
``(enc0 + block*88) mod 90112``; theta = 2π(counter/90112 + azimuth/360),
phi = 2π·altitude/360; x = r·cosθ·cosφ, y = -r·sinθ·cosφ, z = r·sinφ.
Ranges are millimetres; ``meters=True`` scales by 1e-3 afterwards. The
cloud lands on the ``device`` asked for, the card when none is named.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .paths import asset
from .synthetic import RegistrationScene, transformed_scene

PACKETS = 64
BLOCKS_PER_PACKET = 16
CHANNELS = 16
LINES_PER_BLOCK = 788
LINES_PER_PACKET = 12608
ENCODER_TICKS_PER_BLOCK = 88
ENCODER_TICKS_PER_REV = 90112

HALL_GT_TRANSLATION = (0.001, -0.0202, 0.02)
HALL_GT_ROTATION = (0.01, -0.003, 0.05)


class OusterFrame(NamedTuple):
    ranges: np.ndarray  # [N] float32, millimetres
    encoder_start: int  # initial encoder counter
    altitude_deg: np.ndarray  # [16]
    azimuth_deg: np.ndarray  # [16]


def parse_packets(path: Union[str, Path, None] = None) -> OusterFrame:
    """Parse the raw packet byte dump + beam intrinsics into ranges/angles."""
    if path is None:
        path = asset("Donut_1024x16.csv")
    raw = np.array(Path(path).read_text().split(), dtype=np.int64)

    # encoder counter: 1-indexed lines 13, 14 of the first packet
    encoder_start = int(raw[12]) | (int(raw[13]) << 8)

    pkt = np.arange(PACKETS).reshape(-1, 1, 1)
    blk = np.arange(BLOCKS_PER_PACKET).reshape(1, -1, 1)
    ch = (2 + 4 * np.arange(CHANNELS)).reshape(1, 1, -1)
    # reference line index (1-based): 17 + 12*ch + 788*blk + 12608*pkt
    base = 17 + 12 * ch + LINES_PER_BLOCK * blk + LINES_PER_PACKET * pkt - 1
    lo, mid, hi = raw[base], raw[base + 1], raw[base + 2]
    ranges = (lo | (mid << 8) | ((hi & 0xF) << 16)).astype(np.float32)

    alt, azi = parse_beam_intrinsics()
    return OusterFrame(ranges.reshape(-1), encoder_start, alt, azi)


def parse_beam_intrinsics(path: Union[str, Path, None] = None):
    """16 altitude + 16 azimuth beam angles: the file lists 64 of each (the
    OS1-64 table) and the OS1-16 uses every 4th."""
    if path is None:
        path = asset("beam_intrinsics.csv")
    lines = Path(path).read_text().splitlines()
    # 1-based: line 1 header, 2..65 altitudes (take j%4==0 → 4,8,...,64);
    # line 67 header, 68..131 azimuths (take (j-66)%4==0 → 70,74,...,130).
    altitude = np.array(
        [float(lines[j - 1]) for j in range(2, 66) if j % 4 == 0],
        dtype=np.float32)
    azimuth = np.array(
        [float(lines[j - 1]) for j in range(68, 132) if (j - 66) % 4 == 0],
        dtype=np.float32)
    if altitude.size != CHANNELS or azimuth.size != CHANNELS:
        raise ValueError("beam intrinsics parse failed")
    return altitude, azimuth


def polar_to_cartesian(ranges: torch.Tensor, encoder_start: int,
                       altitude_deg: torch.Tensor,
                       azimuth_deg: torch.Tensor) -> torch.Tensor:
    """Spherical→Cartesian conversion of one frame, in float32 on the
    device of ``ranges``. Output is in the unit of ``ranges``."""
    i = torch.arange(ranges.shape[0], device=ranges.device)
    block = i // CHANNELS
    channel = i % CHANNELS
    counter = ((encoder_start + block * ENCODER_TICKS_PER_BLOCK)
               % ENCODER_TICKS_PER_REV)
    theta = 2.0 * math.pi * (
        counter.to(torch.float32) / ENCODER_TICKS_PER_REV
        + azimuth_deg[channel] / 360.0)
    phi = 2.0 * math.pi * altitude_deg[channel] / 360.0
    r = ranges.to(torch.float32)
    cos_phi = torch.cos(phi)
    x = r * torch.cos(theta) * cos_phi
    y = -r * torch.sin(theta) * cos_phi
    z = r * torch.sin(phi)
    return torch.stack([x, y, z], dim=1)


def load_hall_scan(path: Union[str, Path, None] = None, meters: bool = True,
                   device=None) -> torch.Tensor:
    """The full hall-scan cloud: 16,384 Cartesian points."""
    device = resolve_device(device)
    frame = parse_packets(path)
    pts = polar_to_cartesian(
        torch.as_tensor(frame.ranges, device=device),
        frame.encoder_start,
        torch.as_tensor(frame.altitude_deg, device=device),
        torch.as_tensor(frame.azimuth_deg, device=device),
    )
    return pts * 1e-3 if meters else pts


def hall_scene(meters: bool = True, strict: bool = True,
               device=None) -> RegistrationScene:
    """The reference's real-LiDAR benchmark: source = hall scan, target = a
    GT-transformed copy.

    ``strict=True`` reproduces the reference's operation order: the GT
    transform is applied to the millimetre cloud and only then are both
    clouds scaled by 1e-3, so the metres-space translation is
    ``1e-3 × (0.001, -0.0202, 0.02)``. ``strict=False`` applies the full
    translation in metres (the harder variant). With ``meters=False`` the
    translation is applied raw in millimetres and ``strict`` has no effect.
    """
    pts = load_hall_scan(meters=meters, device=device)
    t = HALL_GT_TRANSLATION
    if strict and meters:
        t = tuple(v * 1e-3 for v in t)
    return transformed_scene(pts, t, HALL_GT_ROTATION)
