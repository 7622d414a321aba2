"""Mesh I/O, topology and camera math."""
