"""The plain reference that decides ``correct``: plain PyTorch in float64,
importing nothing of the program (``icp64.py``), and the comparison of the
program's registrations with it (``check.py``)."""
