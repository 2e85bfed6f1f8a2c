"""The fleet plane: what decides how many serving replicas run.

Only :func:`scheduler.read_target` — the decoder of the serving
driver's ``/serve/target_replicas`` key — is in this package so far;
the bin-packing fleet scheduler of the JAX package's ``fleet/`` is
ROADMAP Queue 1 item 8 part 2.
"""
