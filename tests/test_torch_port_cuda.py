"""The port's kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one.  They import
neither JAX nor the JAX package, so they run where only the port is
installed; the repo's conftest imports JAX, so on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from tq_tpu_torch.kernels import term_matmul as tm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(9, 650, 2600), (77, 300, 45),
                                   (128, 784, 512), (350, 650, 2600),
                                   (8192, 2048, 512)])
@pytest.mark.parametrize("bf16_bits,int8_terms", [((8, 3), 3), ((12, 5), 1)],
                         ids=["table", "computed"])
def test_mma_lp_kernel_on_the_card(cuda, M, K, N, bf16_bits, int8_terms):
    """Every bf16 variant and int8_int8 at M > 8 launches the mma_lp
    kernel and holds against the plain version: int8 bit for bit, bf16
    within rtol 1e-5, atol 1e-4 * max|ref|.  The kept values come from the
    kernel's table at up to 8 bits and are computed above (bf16 at 12
    bits); int8 with one term saturates +128 at 127."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(M, K, generator=gen).to(cuda)
    sf = torch.tensor(0.03, device=cuda)
    for variant, (mode, fmt, quantize_x) in tm.VARIANTS.items():
        if mode == "f32":
            continue
        q = torch.randint(-127, 128, (K, N), generator=gen)
        w_sf = torch.tensor(0.0123, device=cuda)
        if fmt in ("f32", "bf16"):
            w, w_sf = (q.to(torch.float32) * 0.001).to(
                getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[fmt])), None
        elif fmt == "packed8":
            w, w_sf = tm.pack_weight_u8s(q.to(torch.float32) * 0.0123,
                                         torch.tensor(0.0123), 8), None
        else:
            w = q.to(getattr(torch, fmt))
        w = (tm.PackedWeight8(*(t.to(cuda) for t in w)) if fmt == "packed8"
             else w.to(cuda))
        bits, terms = (7, int8_terms) if mode == "int8" else bf16_bits
        kw = dict(bf16=mode == "bf16", int8=mode == "int8", w_sf=w_sf,
                  quantize_x=quantize_x)
        before = tm.term_matmul.kernel_launches["mma_lp"]
        out = tm.term_matmul(x, w, sf, bits, terms, **kw)
        ref = tm.term_matmul_ref(x, w, sf, bits, terms, **kw)
        torch.cuda.synchronize()
        assert tm.term_matmul.kernel_launches["mma_lp"] == before + 1
        if mode == "int8":
            assert torch.equal(out, ref), variant
        else:
            torch.testing.assert_close(
                out, ref, rtol=1e-5, atol=1e-4 * float(ref.abs().max()))
