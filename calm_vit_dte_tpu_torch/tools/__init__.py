"""Profiling tools that run on the card (JAX counterparts under scripts/)."""
