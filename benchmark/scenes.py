"""The clouds a configuration names, made by the benchmark itself.

Both kinds come back as float32 numpy arrays ``[N, 3]``; the traffic
generator puts them on the device. Nothing here imports the program, so the
program and the reference get the same points from the same files.

* ``ouster_hall``: the reference's Ouster OS1-16 hall scan. The packet dump
  and the beam table are the files the reference reads, in the repository's
  ``assets/``; the walk over the packets is the reference's
  (``GPU_point_to_point_real.cu``): the encoder count from lines 13/14 of
  the first packet, a 20-bit range from three bytes at line ``17 + 12*ch +
  788*block + 12608*packet`` for channels 2, 6, ..., 62, and the polar to
  Cartesian step in float64, in metres. Returns without a range stay at the
  origin, as in the reference's cloud.
* ``surface_grid``: ``z = x^2 - y^2`` on a regular ``width x width`` grid
  over ``[lo, hi]^2`` (the reference's synthetic scene).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

PACKETS, BLOCKS, CHANNELS = 64, 16, 16
LINES_PER_BLOCK, LINES_PER_PACKET = 788, 12608
TICKS_PER_BLOCK, TICKS_PER_REV = 88, 90112


def _beam_angles(path: Path):
    """The OS1-16's 16 altitudes and azimuths: every 4th row of the OS1-64
    table (lines 4, 8, ..., 64 and 70, 74, ..., 130, 1-based)."""
    lines = path.read_text().splitlines()
    alt = np.array([float(lines[j - 1]) for j in range(2, 66) if j % 4 == 0])
    azi = np.array([float(lines[j - 1]) for j in range(68, 132)
                    if (j - 66) % 4 == 0])
    if alt.size != CHANNELS or azi.size != CHANNELS:
        raise ValueError(f"{path}: expected {CHANNELS} beams")
    return alt, azi


def ouster_hall(packets: str, beams: str) -> np.ndarray:
    raw = np.array((ROOT / packets).read_text().split(), dtype=np.int64)
    enc0 = int(raw[12]) | (int(raw[13]) << 8)
    pkt = np.arange(PACKETS).reshape(-1, 1, 1)
    blk = np.arange(BLOCKS).reshape(1, -1, 1)
    ch = (2 + 4 * np.arange(CHANNELS)).reshape(1, 1, -1)
    base = 17 + 12 * ch + LINES_PER_BLOCK * blk + LINES_PER_PACKET * pkt - 1
    ranges_mm = (raw[base] | (raw[base + 1] << 8)
                 | ((raw[base + 2] & 0xF) << 16)).reshape(-1).astype(
                     np.float64)
    alt, azi = _beam_angles(ROOT / beams)
    i = np.arange(ranges_mm.shape[0])
    block, channel = i // CHANNELS, i % CHANNELS
    counter = (enc0 + block * TICKS_PER_BLOCK) % TICKS_PER_REV
    theta = 2.0 * math.pi * (counter / TICKS_PER_REV + azi[channel] / 360.0)
    phi = 2.0 * math.pi * alt[channel] / 360.0
    r = ranges_mm * 1e-3
    pts = np.stack([r * np.cos(theta) * np.cos(phi),
                    -r * np.sin(theta) * np.cos(phi),
                    r * np.sin(phi)], axis=1)
    return pts.astype(np.float32)


def surface_grid(width: int, lo: float, hi: float) -> np.ndarray:
    axis = np.linspace(lo, hi, width, dtype=np.float64)
    xs, ys = np.meshgrid(axis, axis, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), (xs * xs - ys * ys).ravel()], 1)
    return pts.astype(np.float32)


def make_cloud(scene: dict) -> np.ndarray:
    """The cloud of a configuration's ``scene`` entry."""
    kind = scene["kind"]
    if kind == "ouster_hall":
        return ouster_hall(scene["packets"], scene["beams"])
    if kind == "surface_grid":
        return surface_grid(scene["width"], *scene["xy_range"])
    raise ValueError(f"unknown scene kind {kind!r}")
