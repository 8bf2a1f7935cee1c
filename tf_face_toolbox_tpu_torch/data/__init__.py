"""Data: the FaceShard format, the native loader and the host decode."""
