"""Launchers of the port: the KWT training step builders and the
fault-tolerant training launcher."""
