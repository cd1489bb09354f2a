"""Distributed model parts of the port: the MoE layer."""
