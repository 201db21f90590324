"""Image readers and writers (numpy only)."""
