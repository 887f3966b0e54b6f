"""Configuration, logging, metrics and tracing shared by the port."""
