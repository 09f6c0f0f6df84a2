"""Operation and byte counts of the benchmark (see work.py)."""
