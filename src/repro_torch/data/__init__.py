"""Data pipeline of the port (numpy only)."""
