from tq_tpu_torch.profilers.term_ops import (
    LayerCost,
    cnn_cost,
    compressed_hese_bits,
    conv2d_term_macs,
    dense_param_bits,
    dense_term_macs,
    model_cost,
    param_count,
)

__all__ = [
    "LayerCost",
    "conv2d_term_macs",
    "dense_term_macs",
    "dense_param_bits",
    "compressed_hese_bits",
    "model_cost",
    "cnn_cost",
    "param_count",
]
