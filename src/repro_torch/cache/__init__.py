"""Cache-placement helpers of the port (only the reuse horizon so far)."""
