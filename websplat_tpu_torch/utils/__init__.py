"""Host-side math and image helpers (NumPy)."""
