"""Tokens trained by all ranks in the window over its wall time, on the
hook-driven path: the same rule as ``tokens_per_s``, a metric of its own
because the eager loop's runs spread ten times as widely as the graph's,
and a bound is one number a metric."""

from hvdbench.common import load_file

read = load_file("end_to_end", "tokens_per_s").read
