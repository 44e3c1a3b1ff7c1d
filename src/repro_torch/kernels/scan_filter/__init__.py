"""Kernel K2: equality and range scan over an unsorted key column."""
