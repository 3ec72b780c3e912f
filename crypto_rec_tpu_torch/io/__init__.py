"""Host-side readers and synthetic data."""
