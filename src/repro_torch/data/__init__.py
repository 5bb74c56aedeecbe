"""Training data (port of ``repro.data``)."""
