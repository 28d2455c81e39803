"""Preconditioned CG, the pivoted-Cholesky preconditioner, solver configuration."""
