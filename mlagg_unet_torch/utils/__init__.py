"""File, JSON and dataset-name helpers; device timing and traces
(``profiling``); overlays, batch-run commands and synthetic datasets."""
