"""Distribution: the single-process context only, for now."""
