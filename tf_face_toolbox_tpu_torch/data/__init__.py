"""Data: the FaceShard format, the native loader, the host decode, and
the importers (.rec, TFRecord, verification .bin)."""
