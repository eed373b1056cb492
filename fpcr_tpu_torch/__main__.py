"""``python -m fpcr_tpu_torch ...`` — the CLI (``fpcr_tpu_torch/cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
