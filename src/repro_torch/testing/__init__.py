"""Test support for the port (fault injection seams)."""
