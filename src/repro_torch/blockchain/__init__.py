"""Blocks, ledgers and the vote-tally contract of the port."""
