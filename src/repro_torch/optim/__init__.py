"""Optimizers of the port: AdamW with optional int8 power-of-2 moments."""
