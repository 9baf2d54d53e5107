"""Host-side reference helpers the port calls (Region, plane normalisation, counts)."""
