"""EfficientNet-b0 in the port against the JAX package: the per-arch tests of
``test_torch_port_zoo.py`` on this arch, in a file of its own so that
the test workers share the load."""

import pytest

from test_torch_port_zoo import (  # noqa: F401
    _Arch, one_thread, test_bf16_serving_mode, test_convert_cnn_bit_exact,
    test_cost_columns_match_jax_and_results, test_fp32_apply_matches_jax,
    test_quantized_convs_and_logits_match_jax,
    test_specs_and_settings_match_jax, test_two_phase_calibration_equal_scales)


@pytest.fixture(scope="module", params=["efficientnet_b0"])
def zoo_arch(request):
    return _Arch(request.param)
