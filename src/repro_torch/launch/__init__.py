"""Launch layer of the port: host communicator construction and the serving
CLI."""
