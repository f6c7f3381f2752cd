"""Triangle-mesh input for scene geometry, checkpoints and frame output."""
