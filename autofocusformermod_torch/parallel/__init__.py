"""Numeric policy of the port: bf16 mixed precision (``precision``)."""
