#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tq_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises and the script exits
non-zero without printing a result:

1. build the CUDA kernels of ``tq_tpu_torch/csrc`` with ``nvcc`` (sm_90a)
   and turn TF32 off;
2. hold every kernel body against its plain PyTorch version on the card:
   ``tr_quantize`` (element-wise and grouped) bit for bit, ``term_matmul``
   (f32) within rtol=1e-5, atol=1e-4*max|ref| (float32 sums in another
   order); time each (CUDA events), beside its bound and the plain
   version's time;
3. the main path: the two README MNIST MLP sweeps (UQ ``mnist-quant`` and
   TR ``mnist-tr``) and one ``--fixed-linear`` setting through
   ``run_sweep`` on the card, on ``pretrained/mnist_mlp.npz``; accs,
   tmacs and param_bits must equal the JAX package's (``EXPECTED_SWEEPS``)
   and every kernel must have launched;
4. the ``--fixed-linear`` setting on the card and through the CPU plain
   path on the same 512 test samples: equal calibrated scales, equal
   quantized layer inputs (but for float32-sum-order boundary flips,
   counted), each layer within atol=1e-4 given the same input, and the
   log-probs of the rows without a flip within atol=1e-4.

Then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Needs one CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "pretrained" / "mnist_mlp.npz"

# The README sweeps and the fixed-linear setting, with the JAX package's
# results on the same checkpoint and synthetic data (tq_tpu.evals.mlp's
# run_sweep on the CPU; tmacs/param_bits pinned by
# tests/test_torch_port_mlp.py).
EXPECTED_SWEEPS = {
    "mnist-quant": {
        "settings": dict(wb=[2, 3, 4, 5, 6], wt=[2, 3, 4, 5, 6],
                         db=[6] * 5, dt=[6] * 5, gs=[1] * 5),
        "quantize_input": False,
        "accs": [100.0] * 5,
        "tmacs": [8024064, 12036096, 16048128, 20060160, 24072192],
        "param_bits": [1337344, 2006016, 2674688, 3343360, 4012032],
    },
    "mnist-tr": {
        "settings": dict(wb=[4] * 5, wt=[6, 8, 10, 12, 14],
                         db=[6] * 5, dt=[6] * 5, gs=[16] * 5),
        "quantize_input": False,
        "accs": [100.0] * 5,
        "tmacs": [1504512, 2006016, 2507520, 3009024, 3510528],
        "param_bits": [1000448, 1317100, 1593536, 1821476, 2013724],
    },
    "mnist-tr-fixed-linear": {
        "settings": dict(wb=[4], wt=[6], db=[4], dt=[2], gs=[16]),
        "quantize_input": True,
        "accs": [100.0],
        "tmacs": [501504],
        "param_bits": [1000448],
    },
}

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM
# bytes/s and float32 FLOP/s outside the tensor cores.  The bounds are
# stated against them, beside the card's name and power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67.0e12

KERNELS = {
    "tr_quantize_elementwise": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:192"),
    "tr_quantize_grouped": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:205"),
    "term_matmul_f32": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul.cu",
        replaces="tq_tpu/kernels/term_matmul.py:264"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def eager_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """Time per call of ``fn()`` called back to back from Python: the
    host's launch cost is in it wherever it exceeds the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn()``: ``calls`` calls captured in one
    CUDA graph and replayed, so no host time between launches counts."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def timings(torch, kernel, plain, library=None) -> dict:
    """The kernel's device and eager times, the plain version's and the
    library call's device times (ms per call)."""
    return dict(ms=device_ms(torch, kernel), eager_ms=eager_ms(torch, kernel),
                plain_ms=device_ms(torch, plain),
                library_ms=device_ms(torch, library) if library else None)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time for the work: bytes moved or operations done."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1


def phase_build(torch):
    from tq_tpu_torch.kernels import _build

    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "compiled": not cached, "library": _build.library_path().name,
          "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


# ---------------------------------------------------------------- phase 2


def _boundary_inputs(torch, bits: int, sf: float, dev):
    """Every q < 2**bits as +-q*sf, and the rounding boundaries
    (q+0.5)*sf with their float32 neighbours."""
    q = torch.arange(2**bits, dtype=torch.float32, device=dev)
    half = (q + 0.5) * sf
    inf = torch.tensor(float("inf"), device=dev)
    parts = [q * sf, half, torch.nextafter(half, inf),
             torch.nextafter(half, -inf), (q - 0.5).clamp(min=0) * sf]
    x = torch.cat(parts)
    return torch.cat([x, -x, x * 1.7 + 3 * sf])


def phase_kernels(torch):
    from tq_tpu_torch.kernels.term_matmul import term_matmul, term_matmul_ref
    from tq_tpu_torch.kernels.tr_quantize import (max_hese_terms, tr_quantize,
                                                  tr_quantize_int,
                                                  tr_quantize_int_ref,
                                                  tr_quantize_ref)
    from tq_tpu_torch.layers.common import weight_scale

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def exact(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"{name}: {bad} of {want.numel()} values differ from the "
                 "plain version")

    results = {}
    # tr_quantize element-wise: every q and budget for bits 1..9.
    n_cases = 0
    for bits in range(1, 10):
        x = _boundary_inputs(torch, bits, 0.0371, dev)
        sf = torch.tensor(0.0371, device=dev)
        for budget in range(0, max_hese_terms(bits) + 2):
            for mode in ("largest", "serial"):
                exact(f"elementwise bits={bits} k={budget} {mode}",
                      tr_quantize(x, sf, bits, 1, budget, keep_mode=mode),
                      tr_quantize_ref(x, sf, bits, 1, budget, keep_mode=mode))
                exact(f"elementwise int bits={bits} k={budget} {mode}",
                      tr_quantize_int(x, sf, bits, budget, keep_mode=mode),
                      tr_quantize_int_ref(x, sf, bits, budget,
                                          keep_mode=mode))
                n_cases += 2
    # ... and at the weight shape of fc1, with the weight scale on the card.
    w1 = randn(784, 512, scale=0.05)
    for bits, budget in [(2, 2), (4, 4), (6, 6), (8, 3), (4, 2), (16, 16)]:
        sf = weight_scale(w1, bits)
        for mode in ("largest", "serial"):
            exact(f"elementwise 784x512 bits={bits} k={budget} {mode}",
                  tr_quantize(w1, sf, bits, 1, budget, keep_mode=mode),
                  tr_quantize_ref(w1, sf, bits, 1, budget, keep_mode=mode))
            n_cases += 1
    sf = weight_scale(w1, 6)
    out = tr_quantize(w1, sf, 6, 1, 6)
    ref = tr_quantize_ref(w1, sf, 6, 1, 6)
    n = w1.numel()
    b, by = bound_ms(8 * n, 6 * n)
    results["tr_quantize_elementwise"] = dict(
        cases=n_cases, shape=[784, 512],
        max_abs_err=float((out - ref).abs().max()),
        **timings(torch, lambda: tr_quantize(w1, sf, 6, 1, 6),
                  lambda: tr_quantize_ref(w1, sf, 6, 1, 6)),
        bound_ms=b, bound_by=by)

    # tr_quantize grouped.
    n_cases = 0
    cases = [((24, 64), 9, 8, 12, -1), ((24, 64), 9, 8, 24, -1),
             ((24, 64), 4, 16, 14, -1), ((24, 64), 8, 2, 3, -1),
             ((24, 64), 9, 32, 32, -1), ((24, 64), 16, 8, 16, -1),
             ((3, 50), 8, 16, 20, -1), ((37, 70), 16, 32, 40, 0),
             ((64, 32, 3, 3), 9, 8, 16, 1), ((5, 101), 6, 2, 1, 1),
             ((784, 512), 4, 16, 6, 0), ((784, 512), 4, 16, 14, 0),
             ((512, 10), 4, 16, 10, 0), ((300, 7), 16, 32, 0, 0)]
    for shape, bits, g, k, axis in cases:
        x = randn(*shape)
        sf = weight_scale(x, bits)
        for mode in ("largest", "serial"):
            exact(f"grouped {shape} bits={bits} g={g} k={k} {mode}",
                  tr_quantize(x, sf, bits, g, k, axis, mode),
                  tr_quantize_ref(x, sf, bits, g, k, axis, mode))
            n_cases += 1
    sf = weight_scale(w1, 4)
    out = tr_quantize(w1, sf, 4, 16, 6, 0)
    ref = tr_quantize_ref(w1, sf, 4, 16, 6, 0)
    b, by = bound_ms(8 * n, 6 * n)
    results["tr_quantize_grouped"] = dict(
        cases=n_cases, shape=[784, 512], group_size=16,
        max_abs_err=float((out - ref).abs().max()),
        **timings(torch, lambda: tr_quantize(w1, sf, 4, 16, 6, 0),
                  lambda: tr_quantize_ref(w1, sf, 4, 16, 6, 0)),
        bound_ms=b, bound_by=by)

    # term_matmul f32 at the fixed-linear eval shapes, plus a ragged one.
    per_shape = {}
    for M, K, N in [(128, 784, 512), (128, 512, 512), (128, 512, 10),
                    (77, 300, 45)]:
        x = randn(M, K).relu()
        w = randn(K, N, scale=0.05)
        sf = torch.tensor(0.2, device=dev)
        out = term_matmul(x, w, sf, 4, 2)
        ref = term_matmul_ref(x, w, sf, 4, 2)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        if not torch.allclose(out, ref, rtol=1e-5, atol=1e-4 * scale):
            fail(f"term_matmul {(M, K, N)}: max |diff| "
                 f"{float((out - ref).abs().max())} (max |ref| {scale})")
        xq = tr_quantize_ref(x, sf, 4, 1, 2)  # the library call's input
        b, by = bound_ms(4 * (M * K + K * N + M * N), 2 * M * K * N)
        per_shape[f"{M}x{K}x{N}"] = dict(
            max_abs_err=float((out - ref).abs().max()),
            **timings(torch, lambda: term_matmul(x, w, sf, 4, 2),
                      lambda: term_matmul_ref(x, w, sf, 4, 2),
                      lambda: torch.matmul(xq, w)),
            bound_ms=b, bound_by=by)
    head = per_shape["128x784x512"]
    results["term_matmul_f32"] = dict(
        shape=[128, 784, 512], per_shape=per_shape,
        max_abs_err=max(v["max_abs_err"] for v in per_shape.values()),
        **{k: head[k] for k in ("ms", "eager_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by")})
    emit({"phase": "kernels", "ok": True, "results": results})
    return results


# ---------------------------------------------------------------- phase 3


def phase_main_path(torch):
    from tq_tpu_torch.data import load_mnist
    from tq_tpu_torch.evals.mlp import run_sweep
    from tq_tpu_torch.kernels.term_matmul import term_matmul
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize

    for counts in (tr_quantize.launches, term_matmul.launches):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    got, sweep_seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, exp in EXPECTED_SWEEPS.items():
            s = exp["settings"]
            t1 = time.perf_counter()
            got[name] = run_sweep(
                s["wb"], s["wt"], s["db"], s["dt"], s["gs"],
                str(Path(tmp) / f"{name}.json"), checkpoint=str(CHECKPOINT),
                quantize_input=exp["quantize_input"], verbose=False,
                device="cuda")
            torch.cuda.synchronize()
            sweep_seconds[name] = time.perf_counter() - t1
    seconds = time.perf_counter() - t0
    launches = {"tr_quantize_elementwise": tr_quantize.launches["elementwise"],
                "tr_quantize_grouped": tr_quantize.launches["grouped"],
                "term_matmul_f32": term_matmul.launches["f32"]}
    for name, exp in EXPECTED_SWEEPS.items():
        for key in ("accs", "tmacs", "param_bits"):
            if got[name][key] != [float(v) for v in exp[key]]:
                fail(f"{name} {key}: {got[name][key]} != JAX {exp[key]}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    # What each sweep spends making its synthetic test set, for scale.
    t1 = time.perf_counter()
    load_mnist()
    data_seconds = time.perf_counter() - t1
    emit({"phase": "main_path", "ok": True, "seconds": seconds,
          "sweep_seconds": sweep_seconds, "data_seconds": data_seconds,
          "settings": sum(len(e["accs"]) for e in EXPECTED_SWEEPS.values()),
          "launches": launches, "results": got})
    return launches


# ---------------------------------------------------------------- phase 4


def _layerwise(torch, qparams, qcfg, qstate, x):
    """Per layer: (input, quantized input, output) of the eval forward."""
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.layers.linear import tr_dense_apply
    from tq_tpu_torch.models import mlp

    h = x.reshape(x.shape[0], -1)
    layers = []
    for i, name in enumerate(mlp.LAYER_NAMES):
        tr = qcfg[name]
        hq = tr_quantize(h, qstate[name]["sf"], tr.data_bits, 1,
                         tr.data_terms)
        y, _ = tr_dense_apply(qparams[name], tr, qstate[name], h, False)
        layers.append((h, hq, y))
        h = torch.relu(y) if i < len(mlp.LAYER_NAMES) - 1 else y
    return layers, torch.log_softmax(h, dim=-1)


def phase_fixed_linear(torch):
    from tq_tpu_torch.data import load_mnist
    from tq_tpu_torch.evals.train_mlp import load_or_train
    from tq_tpu_torch.layers.linear import tr_dense_apply
    from tq_tpu_torch.models import mlp

    s = EXPECTED_SWEEPS["mnist-tr-fixed-linear"]["settings"]
    wb, wt, db, dt, gs = (s[k][0] for k in ("wb", "wt", "db", "dt", "gs"))
    _, (x_test, _), _ = load_mnist()
    x = torch.as_tensor(x_test[:512])
    runs = {}
    for dev in ("cuda", "cpu"):
        params = load_or_train(str(CHECKPOINT), device=dev)
        qp, qc, qs = mlp.convert(params, mlp.static_layer_settings(wb, gs, wt),
                                 db, dt, quantize_input=True)
        _, qs = mlp.make_quantized_apply(qc, track=True)(qp, qs, x.to(dev))
        qs = mlp.finalize(qs, qc)
        logp, _ = mlp.make_quantized_apply(qc, track=False)(qp, qs, x.to(dev))
        layers, logp_lw = _layerwise(torch, qp, qc, qs, x.to(dev))
        runs[dev] = dict(qp=qp, qc=qc, qs=qs, logp=logp, layers=layers,
                         logp_lw=logp_lw)
    gpu, cpu = runs["cuda"], runs["cpu"]
    torch.cuda.synchronize()

    sfs = {}
    for name in mlp.LAYER_NAMES:
        a, b = float(gpu["qs"][name]["sf"]), float(cpu["qs"][name]["sf"])
        if a != b:
            fail(f"fixed-linear {name}: calibrated sf {a} (card) != {b} (cpu)")
        sfs[name] = a
        if not torch.equal(gpu["qp"][name]["w"].cpu(), cpu["qp"][name]["w"]):
            fail(f"fixed-linear {name}: term-revealed weights differ")
    if not torch.equal(gpu["logp"], gpu["logp_lw"]):
        fail("fixed-linear: the layer-by-layer forward differs from the model")
    # A quantized input can differ only where a float32 sum landed on the
    # other side of a rounding boundary: count those rows, hold the rest.
    flipped = torch.zeros(x.shape[0], dtype=torch.bool)
    layer_err = {}
    for name, (hg, hqg, _), (hc, hqc, yc) in zip(
            mlp.LAYER_NAMES, gpu["layers"], cpu["layers"]):
        flipped |= (hqg.cpu() != hqc).any(dim=1)
        # Same input on both: the layer's own error.
        yg, _ = tr_dense_apply(gpu["qp"][name], gpu["qc"][name],
                               gpu["qs"][name], hc.cuda(), False)
        err = float((yg.cpu() - yc).abs().max())
        if err > 1e-4:
            fail(f"fixed-linear {name}: layer output differs by {err} on "
                 "the same input")
        layer_err[name] = err
    n_flipped = int(flipped.sum())
    if n_flipped > x.shape[0] // 100:
        fail(f"fixed-linear: {n_flipped} rows with a differing quantized "
             "input, more than sum-order boundary flips explain")
    keep = ~flipped
    logp_err = float((gpu["logp"].cpu()[keep] - cpu["logp"][keep]).abs().max())
    if logp_err > 1e-4:
        fail(f"fixed-linear: log-probs differ by {logp_err}")
    emit({"phase": "fixed_linear", "ok": True, "samples": x.shape[0],
          "setting": [wb, wt, db, dt, gs], "sf": sfs,
          "layer_max_abs_err": layer_err, "rows_with_boundary_flip": n_flipped,
          "logp_max_abs_err": logp_err})


# ------------------------------------------------------------------ main


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU only")
    sys.path.insert(0, str(ROOT))
    import tq_tpu_torch

    if Path(tq_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"tq_tpu_torch imported from {tq_tpu_torch.__file__}, not "
             f"from this checkout ({ROOT})")
    if not CHECKPOINT.exists():
        fail(f"missing checkpoint {CHECKPOINT}")

    t0 = time.perf_counter()
    smi = phase_build(torch)
    card = torch.cuda.get_device_name(0)
    kernel_results = phase_kernels(torch)
    launches = phase_main_path(torch)
    phase_fixed_linear(torch)

    lines = []
    for name, meta in KERNELS.items():
        r = kernel_results[name]
        lines.append({"name": name, **meta, "launches": launches[name],
                      **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "eager_ms")},
                      "match": True})
    emit({"kernels": lines, "card": smi,
          "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
