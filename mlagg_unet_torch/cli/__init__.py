"""Command-line verbs of the port."""
