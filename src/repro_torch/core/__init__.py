"""The port's tensor-cache I/O engine (`spool.py`)."""
