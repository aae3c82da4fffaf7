"""Deterministic test harnesses for the robustness layer.

:mod:`repro_torch.testing.faults` injects file corruption, clock skew,
fire-once process crashes and kill-mid-write into the store and the live
controller.
"""
