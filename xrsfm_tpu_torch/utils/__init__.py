"""Host-side helpers of the port: binary feature I/O, image files,
synthetic scenes and option conversion."""
