"""End-to-end pipelines of the port."""
