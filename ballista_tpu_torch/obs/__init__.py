"""Observability: ambient tracing spans (``tracing.py``), which the shuffle
writer, readers, streams and fault points open."""
