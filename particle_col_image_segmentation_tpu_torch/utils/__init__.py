"""Tracing helpers of the port."""
