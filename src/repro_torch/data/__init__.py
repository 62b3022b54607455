"""Synthetic MNIST-like data and client partitioners (numpy copies of
``repro.data.synthetic`` and ``repro.data.partition``)."""
