"""Kernel K4: k multiply-shift bit tests against a bloom filter."""
