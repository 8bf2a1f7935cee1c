"""interop."""
