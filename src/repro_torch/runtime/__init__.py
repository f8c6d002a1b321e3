"""Decoupled Access/Execute serving on the port's models."""
