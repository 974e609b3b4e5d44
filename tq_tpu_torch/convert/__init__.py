from tq_tpu_torch.convert.cnn import (convert_cnn, finalize_cnn,
                                      make_cnn_apply, pack_cnn)
from tq_tpu_torch.convert.policy import (EXEMPT_SETTING,
                                         static_conv_layer_settings)

__all__ = [
    "static_conv_layer_settings",
    "EXEMPT_SETTING",
    "convert_cnn",
    "make_cnn_apply",
    "finalize_cnn",
    "pack_cnn",
]
