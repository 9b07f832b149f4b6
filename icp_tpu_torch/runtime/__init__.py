"""Runtime layer: configuration and timing."""
