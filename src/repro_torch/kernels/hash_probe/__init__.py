"""Kernel K3: multiply-shift hash probe of a bucket-major table."""
