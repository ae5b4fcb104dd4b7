"""Command-line entry points of the port, and the serving mesh with its
sharding specs."""
