"""Frozen operation and byte counts, and the card's published peaks.

Counts are worked out from a configuration's shapes alone (``counts.py``),
never from how the port lays its work out, so a change that skips work
cannot shrink its own yardstick.
"""
