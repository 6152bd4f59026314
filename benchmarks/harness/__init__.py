"""The harness: finds a cell's files by name, makes its inputs from the
seed, drives the port through the cell's traffic, times it, reads the
per-layer metrics and judges the outputs against ``benchmarks/reference``."""
