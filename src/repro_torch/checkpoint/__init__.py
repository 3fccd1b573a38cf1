"""Catalog checkpoints in the reference package's layout (the weight bridge)."""
