"""Resilience primitives that the fallback backend stands on."""
