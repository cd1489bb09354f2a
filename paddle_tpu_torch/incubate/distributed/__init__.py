"""Distributed incubating APIs of the port: the MoE layer."""
