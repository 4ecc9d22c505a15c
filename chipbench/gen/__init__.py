"""Traffic generation (numpy only)."""
