"""Per-layer TR setting policy.

Port of ``tq_tpu.convert.policy``: every conv layer, in definition order,
gets the sweep's (weight_bits, group_size, weight_terms), except three
exemption classes that get the near-lossless (16, 1, 16): the stem (first
conv, raw-pixel input), depthwise / grouped convs and squeeze-excite convs
(``'se' in name``).  The stem itself is never converted
(:func:`~tq_tpu_torch.convert.cnn.convert_cnn` skips it).
"""

from __future__ import annotations

from typing import Sequence

from tq_tpu_torch.models.cnn_common import ConvSpec

EXEMPT_SETTING = (16, 1, 16)

__all__ = ["static_conv_layer_settings", "EXEMPT_SETTING"]


def static_conv_layer_settings(specs: Sequence[ConvSpec], weight_bits: int,
                               group_size: int, num_terms: int
                               ) -> list[tuple[int, int, int]]:
    """(weight_bits, group_size, weight_terms) per conv spec, in order."""
    return [EXEMPT_SETTING if i == 0 or spec.groups > 1 or spec.is_se
            else (weight_bits, group_size, num_terms)
            for i, spec in enumerate(specs)]
