"""Phase timing and logging."""
