"""The ICP loop."""
