"""Color-space tables and conversions."""
