"""CSV writers with the reference's exact output contract."""
