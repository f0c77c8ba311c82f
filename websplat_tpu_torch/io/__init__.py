"""Host-side cloud IO (PLY)."""
