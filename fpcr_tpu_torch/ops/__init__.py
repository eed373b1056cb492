"""Matching (kernel K1 and its plain version) and the Kabsch solve."""
