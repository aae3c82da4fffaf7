"""Deterministic synthetic data pipeline (token stream + modality stubs), as
the JAX package's ``train/data.py``.

The batch of a step is drawn on the host by numpy from ``SeedSequence([seed,
step])``, tokens first, then frames (encdec) or vision (vlm): the same
arrays, bit for bit, as the reference's, on any device and after any
restart. A configurable host-side latency emulates input-pipeline stalls
(the paper's PCIe/NIC-preceded execution-idle states come largely from
exactly this path, §4.5). ``device_batch_at`` opens the
:func:`repro_torch.obs.span` ``data.device_batch_at``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticDataset:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    #: emulated host-side fetch latency per batch (s); 0 disables
    fetch_latency_s: float = 0.0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        if self.fetch_latency_s > 0:
            time.sleep(self.fetch_latency_s)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (self.global_batch, self.seq_len + 1),
                              dtype=np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (self.global_batch, self.cfg.n_frames, self.cfg.d_model),
                dtype=np.float32)
        if self.cfg.family == "vlm":
            out["vision"] = rng.standard_normal(
                (self.global_batch, self.cfg.n_vision_tokens, self.cfg.d_model),
                dtype=np.float32)
        return out

    def device_batch_at(self, step: int,
                        device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
        """:meth:`batch_at` copied to ``device``: tokens and labels as int64
        (the models' index type), frames and vision as f32."""
        with obs.span("data.device_batch_at"):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                        device, torch.int64 if v.dtype == np.int32 else torch.float32)
                    for k, v in self.batch_at(step).items()}
