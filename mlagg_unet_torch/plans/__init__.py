"""Plans, configurations and labels (numpy only)."""
