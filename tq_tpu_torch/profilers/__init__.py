from tq_tpu_torch.profilers.term_ops import (
    LayerCost,
    compressed_hese_bits,
    conv2d_term_macs,
    dense_param_bits,
    dense_term_macs,
    model_cost,
)

__all__ = [
    "LayerCost",
    "conv2d_term_macs",
    "dense_term_macs",
    "dense_param_bits",
    "compressed_hese_bits",
    "model_cost",
]
