"""Data helpers of the port (the tokenizer the serving path needs)."""
