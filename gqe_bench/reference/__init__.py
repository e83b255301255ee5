"""Plain references of the benchmark: no import of the program."""
