"""models (port)."""
