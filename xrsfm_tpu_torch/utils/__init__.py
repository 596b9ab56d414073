"""Host-side helpers and shared math of the port: binary feature and
COLMAP I/O, image files, geometry and camera models, synthetic scenes and
problems, and option conversion."""
