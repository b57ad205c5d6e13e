"""Deterministic, restart-exact data pipelines of the port."""
