"""Runtime configuration."""
