"""Programs that measure the port (run as ``python -m``)."""
