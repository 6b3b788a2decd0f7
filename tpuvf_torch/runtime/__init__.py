"""Pipeline runtime and parameter carry-over."""
