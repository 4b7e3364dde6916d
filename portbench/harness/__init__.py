"""The general machinery of the benchmark: spec lookup by name, the graph
layout every driver shares, the update pool, the trace arithmetic and the
comparisons that decide `correct`.  Generators and drivers are files of
their own in ``portbench/generators/`` and ``portbench/drivers/``."""
