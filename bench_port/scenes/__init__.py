"""Scene kinds of the benchmark: a configuration names one ("scene")."""
