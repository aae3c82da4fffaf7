"""Serving: the live engine and latency bookkeeping."""
