"""The plain reference that judges the benchmark's runs (imports nothing of
the program)."""
