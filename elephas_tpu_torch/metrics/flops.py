"""Model-FLOPs-utilization accounting (counterpart of ``elephas_tpu/metrics/flops.py``).

MFU = achieved model FLOPs/sec ÷ the card's peak FLOPs/sec (PaLM
appendix B). Model FLOPs count only the mathematically necessary work,
so MFU compares across implementations in a way raw tokens/sec does not.

``transformer_flops_per_token`` uses the 2N-per-token rule for the
matmul work (6N with the backward) plus the attention term
``12 · layers · d_model · seq`` that the parameter count misses.
"""

from __future__ import annotations

from typing import Optional

import torch

# Peak dense bf16 FLOPs/sec (no sparsity), NVIDIA data sheets, SXM parts.
# Matched as a substring of the lower-cased device name.
PEAK_FLOPS: dict = {
    "a100": 312e12,
    "h100": 989e12,
}


def transformer_flops_per_token(
    num_params: int,
    num_layers: int,
    d_model: int,
    seq_len: int,
    *,
    backward: bool = False,
) -> float:
    """Model FLOPs one token costs a decoder-only transformer.

    ``2 * num_params`` matmul FLOPs forward, tripled when ``backward``,
    plus the attention score/value work ``12 * layers * d_model *
    seq_len`` forward (tripled under ``backward``). For KV-cache decode,
    ``seq_len`` is the current context length.
    """
    matmul = 2.0 * num_params
    attn = 12.0 * num_layers * d_model * seq_len
    if backward:
        matmul *= 3.0
        attn *= 3.0
    return matmul + attn


def peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak bf16 FLOPs/sec for ``device_kind`` (default: the name of CUDA
    device 0), or None when the card is not in the table or there is no
    card — MFU against a CPU means nothing."""
    if device_kind is None:
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    kind = device_kind.lower()
    for name, flops in PEAK_FLOPS.items():
        if name in kind:
            return flops
    return None


def mfu(
    tokens_per_sec: float,
    flops_per_token: float,
    peak: Optional[float] = None,
) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None when the peak is
    unknown (see ``peak_flops``)."""
    if peak is None:
        peak = peak_flops()
    if peak is None or peak <= 0 or tokens_per_sec < 0:
        return None
    return tokens_per_sec * flops_per_token / peak
