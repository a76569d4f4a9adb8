"""Dataset and analysis tools."""
