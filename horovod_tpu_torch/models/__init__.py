"""Models served by the port."""
