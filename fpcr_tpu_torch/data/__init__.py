"""Datasets: synthetic scenes, the Stanford Bunny, the Ouster hall scan."""
