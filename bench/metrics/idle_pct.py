"""Share of the traced units (steps or calls) in which no kernel or copy ran
on the card: 1 - the union of the device intervals over the traced window."""
from bench.readers import idle_pct as read  # noqa: F401

RANGES = ()
