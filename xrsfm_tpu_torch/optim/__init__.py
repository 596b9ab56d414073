"""Bundle adjustment of the port."""
