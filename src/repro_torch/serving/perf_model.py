"""Serving performance model: request service time on a (platform, model).

Roofline-derived defaults with a calibration hook:

* decode is memory-bound: tokens/s ~ HBM_bw / bytes(model + KV slice),
  scaled by a batching-efficiency factor (continuous batching amortizes the
  weight stream over concurrent sequences),
* prefill is compute-bound: tokens/s ~ peak_flops * mfu / (2 * N_active).

``LLAMA13B_L40S`` is the paper's calibration, not a measurement of any card
this package runs on: Llama-13B on one L40S under vLLM, the operating point
of the §5.1 / §5.3 experiments.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class PerfModel:
    prefill_tps: float          # prompt tokens / s (effective, batched)
    decode_tps: float           # output tokens / s (effective, batched)
    #: device utilization (for the power model) while serving work runs
    busy_util: float = 0.25

    def service_time_s(self, prompt_tokens: int, output_tokens: int) -> float:
        return prompt_tokens / self.prefill_tps + output_tokens / self.decode_tps


def from_roofline(cfg: ModelConfig, peak_tflops: float, hbm_gbps: float,
                  n_params: int | None = None, batch_eff: float = 8.0,
                  prefill_mfu: float = 0.45) -> PerfModel:
    """Derive effective rates from hardware + model size."""
    if n_params is None:
        # rough dense estimate
        n_params = cfg.n_layers * (4 * cfg.d_model * cfg.n_heads *
                                   cfg.resolved_head_dim +
                                   3 * cfg.d_model * cfg.d_ff) \
            + cfg.vocab_size * cfg.d_model
    bytes_per_token_stream = 2 * n_params            # bf16 weight read
    decode_tps = batch_eff * hbm_gbps * 1e9 / bytes_per_token_stream
    prefill_tps = prefill_mfu * peak_tflops * 1e12 / (2 * n_params)
    return PerfModel(prefill_tps=prefill_tps, decode_tps=decode_tps)


#: The paper's replay operating point: Llama-13B on one L40S under vLLM.
#: Calibrated so the Azure-Code replay reproduces the paper's busy fraction
#: (~24%) and average power (123.9 W).
LLAMA13B_L40S = PerfModel(prefill_tps=3200.0, decode_tps=55.0, busy_util=0.25)
