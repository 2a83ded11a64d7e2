"""Optimizer of the port: mixed-precision Adam on fp32 master weights."""
