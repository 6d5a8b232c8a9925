"""Plain references of the benchmark's configurations, one package each,
named by a configuration's ``reference`` key."""
