"""Query engines of the port (minimizer engine only)."""
