"""Timed loops, one a kind of entry (``traffic/*.json``: ``entry``)."""
