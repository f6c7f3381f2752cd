"""Config tree, metrics and timers."""
