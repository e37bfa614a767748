from elephas_tpu_torch.metrics.flops import (  # noqa: F401
    PEAK_FLOPS,
    mfu,
    peak_flops,
    transformer_flops_per_token,
)
