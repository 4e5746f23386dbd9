"""Weight bridges."""
