"""Deterministic sharded token pipeline (numpy only)."""
