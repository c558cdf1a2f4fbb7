"""Host-side dataset metadata of the port (numpy only)."""
