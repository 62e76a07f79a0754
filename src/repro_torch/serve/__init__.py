"""serve (port)."""
