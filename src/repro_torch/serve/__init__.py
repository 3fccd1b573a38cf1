"""Serving of the port's language models (the static-batch engine)."""
