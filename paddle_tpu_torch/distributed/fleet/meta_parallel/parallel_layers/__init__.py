"""The tensor-parallel layers."""
