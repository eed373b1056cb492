"""Dataset asset resolution: the repository's ``assets/`` directory, or the
directory named by ``FPCR_DATA_DIR``."""

from __future__ import annotations

import os
from pathlib import Path

_REPO_ASSETS = Path(__file__).resolve().parents[2] / "assets"


def data_dir() -> Path:
    env = os.environ.get("FPCR_DATA_DIR")
    return Path(env) if env else _REPO_ASSETS


def asset(name: str) -> Path:
    path = data_dir() / name
    if not path.exists():
        raise FileNotFoundError(
            f"dataset asset {name!r} not found under {data_dir()} "
            "(set FPCR_DATA_DIR to the directory holding the CSV assets)"
        )
    return path
