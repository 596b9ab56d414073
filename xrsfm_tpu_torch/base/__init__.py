"""Host-side reconstruction state and its COLMAP bridge."""
