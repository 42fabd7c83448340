"""Host-side fixture batches (NumPy)."""
