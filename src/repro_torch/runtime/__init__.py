"""Fault-tolerant training runtime of the port."""
