"""Checkpoints of long runs."""
