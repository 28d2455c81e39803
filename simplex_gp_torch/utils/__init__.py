"""Datasets (a verbatim copy of simplex_gp_tpu/utils/data.py, which needs no jax)."""
