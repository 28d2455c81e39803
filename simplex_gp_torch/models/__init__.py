"""SimplexGP and its parameter constraints."""
