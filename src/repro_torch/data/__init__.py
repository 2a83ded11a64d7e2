"""Data pipeline of the port: deterministic synthetic token streams."""
