"""Lattice filter operators (join engine), kernels and coefficient search."""
