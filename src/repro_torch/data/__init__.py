"""Synthetic data and client partitioners (numpy copies of
``repro.data.synthetic``, ``repro.data.partition`` and the dataset part of
``repro.data.tokens``)."""
