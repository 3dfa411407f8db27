"""Platform glue of the port (the X display's socket path so far)."""
