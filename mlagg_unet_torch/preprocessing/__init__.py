"""Per-case preprocessing: crop, normalise, resample (numpy only)."""
