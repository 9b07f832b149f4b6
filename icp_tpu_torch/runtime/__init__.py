"""Runtime layer: configuration."""
