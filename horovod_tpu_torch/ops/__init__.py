"""Collectives, compression and the hand-written kernels of the port."""
