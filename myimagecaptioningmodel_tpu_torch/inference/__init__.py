"""Caption server and single-image inference."""
