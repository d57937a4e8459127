"""Host-side data for the port (NumPy only)."""
