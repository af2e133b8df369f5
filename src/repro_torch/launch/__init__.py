"""Launch layer of the port: the LM serve step and the serve entry point."""
