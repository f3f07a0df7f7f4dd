"""Checkpointed period-grid sweeps."""
