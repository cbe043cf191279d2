"""Policy/value networks."""
