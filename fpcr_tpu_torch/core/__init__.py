"""Clouds, rigid transforms and error metrics."""
