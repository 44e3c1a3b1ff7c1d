"""Synthetic token pipeline of the port."""
