"""The general machinery of the benchmark: spec lookup by name, the
generators, the drivers of each kind of traffic, the trace arithmetic and
the comparisons that decide `correct`."""
