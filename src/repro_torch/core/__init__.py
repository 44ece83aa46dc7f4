"""Spike codec and coded boundaries (world size 1)."""
