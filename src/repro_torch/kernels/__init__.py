"""kernels (port)."""
