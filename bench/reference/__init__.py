"""Plain float32 references, one file a configuration (``<config>.py``)."""
