"""The harness that drives the port's cells (see ``portbench/run.py``)."""
