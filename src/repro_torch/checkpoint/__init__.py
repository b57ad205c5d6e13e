"""Fault-tolerant checkpointing of parameter trees."""
