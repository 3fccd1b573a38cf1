"""Data plane of the port: the tokenizer, the stateless samplers and the
index-backed training pipeline."""
