"""What the benchmark's CPU tests share: the DeepSeek-V3 configuration at
a size the CPU holds.

``test_benchmark_checks.py`` drives every cell's check at a size it
gives each model; a ``deepseek_v3`` configuration has none there (16 B
parameters at any vocabulary), so in these tests every cell of one is
read (``benchmark.run.cell_spec``) at :data:`TINY` widths with
:data:`TINY_TRAFFIC`: the same program, reference, loop and limits.
"""

from __future__ import annotations

import pytest

# Hidden 64, 4 heads (nope 16, rope 8, v 16), latent 32, 8 experts of
# width 32, top 3, 1 shared, 3 layers with the first dense, vocab 211.
TINY = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "kv_lora_rank": 32, "intermediate_size": 96,
    "moe_intermediate_size": 32, "n_routed_experts": 8,
    "n_shared_experts": 1, "num_experts_per_tok": 3,
    "num_hidden_layers": 3, "vocab_size": 211,
}
TINY_TRAFFIC = {"batch": 4, "context": 12, "steps": 3, "prefill_rows": 24,
                "check_rows": 2, "check_layers": 2}


@pytest.fixture(autouse=True)
def _tiny_deepseek_v3(monkeypatch):
    from benchmark import run as bench

    real = bench.cell_spec

    def cell_spec(manifest, workload):
        cell, cfg, traffic, e2e, layer = real(manifest, workload)
        if cfg.get("model") == "deepseek_v3":
            cfg.update(TINY)
            traffic.update(TINY_TRAFFIC)
        return cell, cfg, traffic, e2e, layer

    monkeypatch.setattr(bench, "cell_spec", cell_spec)
