"""launch (port)."""
