"""Training of the port: AdamW, the train step and the trainer."""
