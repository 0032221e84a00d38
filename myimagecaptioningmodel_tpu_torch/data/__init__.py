"""Image preprocessing for the port (``image``)."""
