"""Parity figures (matplotlib, imported only when figures are drawn)."""
