"""Drivers: the set-up and the timed run of one kind of traffic, found by
the ``driver`` name of a traffic mix (``perfbench/traffic/<mix>.json``)."""
