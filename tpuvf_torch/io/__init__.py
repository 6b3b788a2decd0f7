"""Host-side file readers of the port (numpy only)."""
