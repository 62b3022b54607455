"""The yardstick: cells read from data, traffic, weights, counts, trace
reduction, the calls into the program and the comparison that decides
``correct``."""
