"""Bundle loading for decode."""
