"""Host-side fixture batches and the ``.mats`` format (NumPy)."""
