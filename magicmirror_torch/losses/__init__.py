"""The loss suite, the port of ``magicmirror/losses``: image / mask
reconstruction, the attribute cycle, chamfer, mesh regularizers, WGAN-GP."""
