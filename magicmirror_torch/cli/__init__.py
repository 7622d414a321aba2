"""Command-line entry points, the port of ``magicmirror/cli`` (``train``)."""
