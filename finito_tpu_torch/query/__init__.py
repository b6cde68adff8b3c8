"""Query engines of the port: minimizer, dense, stream and replica."""
