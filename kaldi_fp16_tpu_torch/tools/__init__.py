"""Command-line tools of the PyTorch port (torch twins of tools/*.py)."""
