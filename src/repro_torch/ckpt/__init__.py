"""Checkpointing (port of the reference's ``ckpt/``)."""
