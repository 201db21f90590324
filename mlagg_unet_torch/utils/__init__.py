"""File, JSON and dataset-name helpers."""
