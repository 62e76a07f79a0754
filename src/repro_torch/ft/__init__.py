"""Fault-tolerance runtime (port of the reference's ``ft/``)."""
