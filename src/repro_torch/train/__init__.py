"""Serving steps of the port (training comes with ``optim/``)."""
