"""Command-line runners of the port."""
