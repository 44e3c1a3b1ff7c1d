"""Kernel K1: sorted search and the sorted-array Get."""
