"""Per-plane region analytics of the port (``labels.analysis``)."""
