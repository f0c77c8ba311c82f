"""Camera model (NumPy)."""
