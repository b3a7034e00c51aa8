"""Launchers of the port (twins of ``repro.launch``): ``serve`` and
``train``."""
