"""See the module docstrings."""
