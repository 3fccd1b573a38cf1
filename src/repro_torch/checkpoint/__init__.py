"""Catalog checkpoints in the reference package's layout (the weight and
train-state bridge) and the run's checkpoint manager."""
