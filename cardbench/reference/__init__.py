"""Plain references the benchmark holds the program's answers to."""
