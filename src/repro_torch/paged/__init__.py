"""paged (port)."""
