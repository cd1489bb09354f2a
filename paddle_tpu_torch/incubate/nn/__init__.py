"""Incubating functionals of the port (``paddle_tpu.incubate.nn``)."""
