"""Models of the port (registering themselves on import)."""
