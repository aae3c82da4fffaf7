"""Roofline tooling of the dry-run: the per-rank terms of a step traced on
the ``meta`` device (``op_count``), their derivation under an H100's
constants (``analysis``), and the cached op logs' re-derivation and report
(``rederive``, ``report``)."""
