"""Pre-defined sparse patterns (numpy; the port's own copies)."""
