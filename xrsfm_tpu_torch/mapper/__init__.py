"""The incremental mapper of the port: initialization, registration,
triangulation, bundle-adjustment glue, keyframes and the main loop."""

from .incremental import IncrementalMapper, MapperOptions  # noqa: F401
