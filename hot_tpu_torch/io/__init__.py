"""Triangle-mesh input for scene geometry."""
