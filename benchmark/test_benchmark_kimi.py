"""The Kimi-Linear cell's check on the CPU, at the loop's tiny size (the
same program, reference and limits): a sound run is correct; the
control (the reference at TF32 in the program's place) and runs with the
timed path broken underneath are not: a decay left out of KDA, a
restore that copies nothing, the prefill's last chunk dropped.  And the
cell's work counts at the published shapes."""

from __future__ import annotations

import pytest
import torch

from benchmark.test_benchmark_checks import drive
from benchmark.work import kimi_linear as work

CELL = "kimilinear48b-tr-decode-b256"


def _break(monkeypatch, fault: str) -> None:
    from tq_tpu_torch.layers import kda
    from tq_tpu_torch.models import kimi_linear as kimi

    if fault == "decay_left_out":
        monkeypatch.setattr(kda, "decay", lambda f, A_log, dt_bias, heads:
                            torch.zeros_like(f).unflatten(-1, (heads, -1)))
    elif fault == "restore_copies_nothing":
        def restore(cache, snap):
            cache.counts["restores"] += 1

        monkeypatch.setattr(kimi, "restore", restore)
    else:  # the chunked prefill stops one chunk short
        real = kda.chunked

        def chunked(q, k, v, g, beta, state=None, chunk=kda.CHUNK):
            T = k.shape[1]
            keep = (T - 1) // chunk * chunk
            o, s = real(q[:, :keep], k[:, :keep], v[:, :keep], g[:, :keep],
                        beta[:, :keep], state, chunk)
            return torch.cat([o, o.new_zeros(o.shape[0], T - keep,
                                             *o.shape[2:])], 1), s

        monkeypatch.setattr(kda, "chunked", chunked)


def test_a_sound_run_is_correct_and_reads_every_check():
    result = drive(CELL)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {
        "weight_mismatch", "route_mismatch", "layer_gap", "state_gap",
        "cache_gap", "logit_gap", "restore_mismatch"}
    assert result["checks"]["restore_mismatch"]["value"] == 0


def test_the_control_is_not_correct():
    result = drive(CELL, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["decay_left_out", "restore_copies_nothing",
                                   "last_prefill_chunk_dropped"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    result = drive(CELL)
    assert not result["correct"], result["checks"]


PUBLISHED = {
    "hidden_size": 2304, "num_hidden_layers": 27, "vocab_size": 163840,
    "linear_attn_config": {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
                           "head_dim": 128, "num_heads": 32,
                           "short_conv_kernel_size": 4,
                           "kda_layers": [i for i in range(1, 27) if i % 4]},
    "num_attention_heads": 32, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "kv_lora_rank": 512,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "intermediate_size": 9216, "moe_intermediate_size": 1024,
    "num_experts": 64, "router_experts": 256, "num_experts_per_token": 8,
    "num_shared_experts": 1, "serving": {"pack": "u8s"},
}


def test_the_cells_work_at_the_published_shapes():
    # KDA: 20 layers x 256 sessions x (32 x 128 x 128 state + 12,288 x 3
    # tail floats), read and written once: 23.0 GB (and 0.5 GB of its
    # inputs and outputs), ~54% of the step.
    ops, nbytes = work.kernel(PUBLISHED, "kda", 256)
    state = 20 * 256 * 4 * (32 * 128 * 128 + 12288 * 3)
    assert state * 2 < nbytes < state * 2 * 1.03
    assert round(state * 2 / 1e9, 1) == 23.0
    step_ops, step_bytes = work.step(PUBLISHED, 256, 1024 + 33 / 2)
    assert 0.5 < nbytes / step_bytes < 0.6
    # Every held expert's packed weights: 26 x 64 x 3 x 2304 x 1024
    # weights (11.8 B) at 9/8 bytes.
    experts = 26 * 64 * 3 * 2304 * 1024 * 9 / 8
    tm_ops, tm_bytes = work.kernel(PUBLISHED, "term_matmul", 256)
    assert experts < tm_bytes < step_bytes
    assert round(experts / 1e9, 1) == 13.2
    # ~1.2 TFLOP a step, most of it the TR products.
    assert 0.8e12 < tm_ops < step_ops < 1.5e12
