#!/usr/bin/env python3
"""Device time of one checkout's element-wise ``tr_quantize`` (B1) and
``tr_scale_copy`` (B5), and what they move end to end; or, with
``--grouped``, of its grouped body (B2).

    python3 scripts/time_tr_quantize.py --root DIR [--sass FILE]
    python3 scripts/time_tr_quantize.py --root DIR --grouped

Imports ``tq_tpu_torch`` from the checkout DIR (any commit of the port;
its kernels are built there at first use) and, on seeded inputs like
those of ``chip_smoke.py``'s ``cnn_kernels`` phase (bits 9, 3 terms,
sf 0.05):

* times by CUDA-graph replay (``chip_smoke.device_ms``) B1 on float32
  and bfloat16 input, each with its int32-output variant, B5 and
  ``torch.mul(x, sf)`` at the four ResNet-18 activation shapes at batch 64
  (``chip_smoke.RESNET_ACTIVATIONS``) and at the LSTM's activations
  (``LSTM``): (1, 650) in the serving generator; in the sweep at batch
  10, (10, 650) one layer's h or c and (350, 650) a 35-step chunk's
  embeddings;
* where the checkout's wrapper splits launches (``_chunks``), times B1
  and B5 at ``SPAN_N`` elements on both spans ``plan()`` chooses between,
  16-byte vectors and one element a thread (``spans``);
* times B1's eager call at (1, 650) (``chip_smoke.eager_ms``, the least
  of 5 readings: the host's launch path, which bounds generation);
* times ``term_matmul``'s f32 mode at (128, 784, 512) (the ``mma``
  kernel, which shares B1's reveal helpers);
* measures TR ResNet-18 images/s at batch 64 in float32 and bfloat16
  (``chip_smoke._images_per_s``, 20 forwards after 2 of warm-up) on
  ``chip_smoke.resnet_checkpoint``'s weights at the flagship's settings.

``--grouped`` times B2 instead, at every weight shape the paths give it
(``GROUPED``: the MNIST MLP's three dense weights, the LSTM's recurrent
weights and its tied decoder, a transposed view of the encoder, and the
ten distinct converted ResNet-18 conv weights), each held equal to the
plain version first, beside its byte bound and B5 on as many elements
(its copy ceiling); B2's eager call at (784, 512) (the least of 5
readings);
and B2's device time a ResNet-18 sweep setting (the 19 converted convs).

``--sass FILE`` also writes the SASS of the checkout's kernel library to
FILE (``cuobjdump -sass``) and prints the instructions of each
element-wise kernel: in all, in its vector loop, in the fallback
divisions and the keep-terms loops inside it, and the loop's common path
per element with the keep-terms loops run 3 times (``sass_counts``).

To compare two commits on one card, run it once per checkout in the
order parent, change, change, parent.  Prints one JSON line: the
checkout, the card's ``nvidia-smi`` name and power limit, and ms per call.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SERVING = (1, 650)
# The LSTM LM's activations at width 650: the serving generator's; at the
# sweep's batch 10, one layer's h or c and a 35-step chunk's embeddings.
LSTM = [SERVING, (10, 650), (350, 650)]
# Element counts at which both spans plan() chooses between are timed.
SPAN_N = [650, 6_500, 65_000, 227_500, 455_000, 910_000, 1_605_632]
# B2 on the paths: name -> (shape, axis, g, bits, terms, transposed).  The
# MLP's mnist-tr setting (wb 4, g 16, 6 terms), the LSTM's g = 8 setting
# (wb 8, 24 terms; the tied decoder is the encoder's transpose), and the
# ResNet-18 flagship's (9, 8, 12) on the converted convs (appended in
# grouped()).
GROUPED = {
    "mlp_784x512": ((784, 512), 0, 16, 4, 6, False),
    "mlp_512x512": ((512, 512), 0, 16, 4, 6, False),
    "mlp_512x10": ((512, 10), 0, 16, 4, 6, False),
    "lstm_650x2600": ((650, 2600), 0, 8, 8, 24, False),
    "lstm_decoder_650x33278": ((650, 33278), 0, 8, 8, 24, True),
}


def sass_counts(library: Path, out: Path, budget: int = 3) -> dict:
    """Instructions of each element-wise kernel in the library's SASS: in
    all; in its vector loop (the outermost backward branch around a
    16-byte store); in the fallback divisions inside it (the code that
    forward branches skip, holding a CALL); in its keep-terms loops
    (the backward branches inside it); and an estimate of a loop pass's
    common path per element with the keep-terms loops run ``budget``
    times."""
    dump = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(library)], capture_output=True, text=True,
                          check=True).stdout
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(dump)
    counts = {}
    for part in re.split(r"\n\s*Function : ", dump)[1:]:
        name = part.split("\n", 1)[0].strip()
        if "elementwise_kernel" not in name and "scale_copy" not in name:
            continue
        ops, addr, labels = [], [], {}
        for ln in part.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", ln)
            if m:
                labels[m.group(1)] = len(ops)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", ln)
            if m:
                addr.append(int(m.group(1), 16))
                ops.append(re.sub(r"^@!?U?P\w+\s+", "", m.group(2)))
        branches = []  # (branch index, target index)
        for i, o in enumerate(ops):
            m = re.match(r"BRA\b.*?(?:\((\.L_x_\d+)\)|(0x[0-9a-f]+))", o)
            if m:
                t = (labels.get(m.group(1)) if m.group(1) else
                     addr.index(int(m.group(2), 16))
                     if int(m.group(2), 16) in addr else None)
                if t is not None:
                    branches.append((i, t))

        def count(lo, hi):
            return sum(1 for i in range(lo, hi + 1)
                       if not ops[i].startswith("NOP"))

        def has(lo, hi, op):
            return any(ops[k].startswith(op) for k in range(lo, hi))

        entry = {"instructions": count(0, len(ops) - 1)}
        loops = [(t, b) for b, t in branches
                 if t <= b and has(t, b, "STG") and ".128" in
                 " ".join(ops[t:b])]
        if loops:
            lo, hi = min(loops, key=lambda r: r[0] - r[1])
            skipped = set()
            for b, t in branches:
                if lo < b < t <= hi and has(b, t, "CALL"):
                    skipped.update(range(b + 1, t))
            keep = [(t, b) for b, t in branches if lo < t <= b < hi]
            keep_n = sum(count(t, b) for t, b in keep)
            loop_n = count(lo, hi)
            fallback = sum(1 for i in skipped if not ops[i].startswith("NOP"))
            elems = 8 * (2 if "bfloat16" in name else 1)
            entry.update(
                vector_loop=loop_n, fallback=fallback, keep_terms=keep_n,
                per_element=(loop_n - fallback - keep_n + budget * keep_n)
                / elems)
        counts[name] = entry
    return counts


def spans(torch, tk, _build, device_ms, sf, gen) -> dict:
    """B1 (float32 and bfloat16 in) and B5 at each of ``SPAN_N`` elements
    on both spans ``tk.plan`` chooses between, whichever it would choose:
    16-byte vectors on whole waves, and one element a thread (each held
    equal to the plain version first)."""
    lib, dev = _build.load(), torch.device("cuda")
    sms = tk._sm_count(dev.index or 0)
    out = {}
    for n in SPAN_N:
        x = torch.randn(n, generator=gen, device=dev) * 2
        row = {}
        for name, xs, variant in (("b1_f32", x, 0),
                                  ("b1_bf16", x.to(torch.bfloat16), 1),
                                  ("b5", x, tk._SCALE_COPY)):
            res = torch.empty_like(xs)
            size = xs.element_size()
            per_sm = tk._blocks_per_sm(dev.index or 0, variant)
            # plan() on a card of one SM that runs every block takes the
            # vectors wherever x has any; on one of 2^31 SMs, never.
            for span, p in (("vectors", tk.plan(n, 0, 0, size, size, 1,
                                                sms * per_sm)),
                            ("singles", tk.plan(n, 0, 0, size, size, 2**31,
                                                per_sm))):
                if variant == tk._SCALE_COPY:
                    def call(p=p):
                        _build.check(lib.tq_tr_scale_copy(
                            x.data_ptr(), sf.data_ptr(), res.data_ptr(),
                            p.head, p.n_vec, p.tail, p.blocks,
                            _build.stream(x.device)), "tq_tr_scale_copy")
                    want = tk.tr_scale_copy_ref(x, sf)
                else:
                    def call(p=p, xs=xs, variant=variant):
                        _build.check(lib.tq_tr_quantize_elementwise(
                            xs.data_ptr(), sf.data_ptr(), res.data_ptr(),
                            p.head, p.n_vec, p.tail, p.blocks, 9, 3,
                            variant, _build.stream(xs.device)),
                            "tq_tr_quantize_elementwise")
                    want = tk.tr_quantize_ref(xs, sf, 9, 1, 3)
                call()
                torch.cuda.synchronize()
                if not torch.equal(res, want):
                    sys.exit(f"{name} at {n} on the {span} span differs "
                             "from the plain version")
                row[f"{name}_{span}"] = device_ms(torch, call)
            row[f"{name}_plan"] = "vectors" if tk._plan_for(
                xs, res, variant).vec > 1 else "singles"
        out[str(n)] = row
    return out


def grouped(torch, tk, device_ms, eager_ms, gen) -> dict:
    """B2 at every path shape (``GROUPED`` and the converted ResNet-18
    convs): device ms, bound and copy ceiling; eager ms at (784, 512); ms
    a sweep setting."""
    from tq_tpu_torch.layers.common import weight_scale
    from tq_tpu_torch.models.resnet import conv_specs

    convs = [(s.kh, s.kw, s.in_ch, s.out_ch) for s in conv_specs()[1:]]
    shapes = dict(GROUPED)
    for shape in dict.fromkeys(convs):
        shapes["resnet_" + "x".join(map(str, shape))] = (shape, 2, 8, 9,
                                                         12, False)
    dev = torch.device("cuda")
    out = {}
    for name, (shape, axis, g, bits, k, transposed) in shapes.items():
        x = torch.randn(*(shape[::-1] if transposed else shape),
                        generator=gen, device=dev) * 0.05
        x = x.T if transposed else x
        sf = weight_scale(x, bits)
        want = tk.tr_quantize_ref(x, sf, bits, g, k, axis)
        got = tk.tr_quantize(x, sf, bits, g, k, axis)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            sys.exit(f"B2 at {name} differs from the plain version")
        xc = x.contiguous()
        out[name] = {
            "ms": device_ms(torch, lambda: tk.tr_quantize(x, sf, bits, g, k,
                                                         axis)),
            "copy_ceiling_ms": device_ms(torch, lambda: tk.tr_scale_copy(
                xc, sf)),
            "bound_ms": 8 * x.numel() / 3.35e12 * 1e3}
    x = torch.randn(784, 512, generator=gen, device=dev) * 0.05
    sf = weight_scale(x, 4)
    eager = min(eager_ms(torch, lambda: tk.tr_quantize(x, sf, 4, 16, 6, 0))
                for _ in range(5))
    setting = sum(out["resnet_" + "x".join(map(str, c))]["ms"] for c in convs)
    return {"ms": out, "eager_ms_784x512": eager,
            "resnet_setting_ms": setting, "resnet_convs": len(convs)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True,
                    help="checkout whose tq_tpu_torch is timed")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the kernel library's SASS here and count "
                         "the element-wise kernels' instructions")
    ap.add_argument("--grouped", action="store_true",
                    help="time the grouped body (B2) at the paths' weight "
                         "shapes instead")
    args = ap.parse_args()
    root = args.root.resolve()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import (FLAGSHIP, RESNET_ACTIVATIONS, _images_per_s,
                            _with_sf, device_ms, eager_ms, nvidia_smi_line,
                            resnet_checkpoint)

    sys.path.insert(0, str(root))
    import tq_tpu_torch
    from tq_tpu_torch.kernels import _build
    from tq_tpu_torch.kernels import tr_quantize as tk
    from tq_tpu_torch.kernels.term_matmul import term_matmul

    if Path(tq_tpu_torch.__file__).resolve().parent.parent != root:
        sys.exit(f"tq_tpu_torch imported from {tq_tpu_torch.__file__}, "
                 f"not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    sf = torch.tensor(0.05, device=dev)
    if args.grouped:
        print(json.dumps({"root": str(root), "card": nvidia_smi_line(),
                          **grouped(torch, tk, device_ms, eager_ms, gen)}),
              flush=True)
        return

    def kernels(x, xb):
        return {
            "b1_f32": lambda: tk.tr_quantize(x, sf, 9, 1, 3),
            "b1_f32_int": lambda: tk.tr_quantize_int(x, sf, 9, 3),
            "b1_bf16": lambda: tk.tr_quantize(xb, sf, 9, 1, 3),
            "b1_bf16_int": lambda: tk.tr_quantize_int(xb, sf, 9, 3),
            "b5": lambda: tk.tr_scale_copy(x, sf),
            "torch_mul": lambda: torch.mul(x, sf)}

    ms = {}
    for shape in [*RESNET_ACTIVATIONS, *LSTM]:
        x = torch.randn(*shape, generator=gen, device=dev) * 2
        xb = x.to(torch.bfloat16)
        ms["x".join(map(str, shape))] = {
            name: device_ms(torch, fn) for name, fn in kernels(x, xb).items()}
    if hasattr(tk, "_chunks"):
        ms["spans"] = spans(torch, tk, _build, device_ms, sf, gen)
    x = torch.randn(*SERVING, generator=gen, device=dev)
    eager = {"b1_f32_1x650": min(eager_ms(  # the least of 5: host noise
        torch, lambda: tk.tr_quantize(x, sf, 8, 1, 3)) for _ in range(5))}

    xm = torch.randn(128, 784, generator=gen, device=dev).relu()
    wm = torch.randn(784, 512, generator=gen, device=dev) * 0.05
    smm = torch.tensor(0.2, device=dev)
    mma_ms = device_ms(torch, lambda: term_matmul(xm, wm, smm, 4, 2))

    from tq_tpu_torch.convert import (convert_cnn, make_cnn_apply,
                                      static_conv_layer_settings)
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.models import resnet

    f = FLAGSHIP
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "resnet_seeded.npz"
        resnet_checkpoint(ckpt)
        _, params = load_params("resnet18", str(ckpt), device="cuda")
    settings = static_conv_layer_settings(resnet.conv_specs(), *f["tr"])
    qp, qc, qs = convert_cnn(resnet, params, settings, f["db"], f["dt"])
    qs = _with_sf(torch, qs, f["sf"])
    x64 = torch.randn(64, f["image"], f["image"], 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    f32_fwd = make_cnn_apply(resnet, qc, track=False)
    bf16_fwd = make_cnn_apply(resnet, qc, track=False,
                              compute_dtype=torch.bfloat16)
    images_per_s = {
        "tr_f32": _images_per_s(torch, lambda: f32_fwd(qp, qs, x64), 64, 20),
        "tr_bf16": _images_per_s(torch, lambda: bf16_fwd(qp, qs, x64), 64,
                                 20)}

    result = {"root": str(root), "card": nvidia_smi_line(), "ms": ms,
              "eager_ms": eager, "mma_128x784x512_ms": mma_ms,
              "images_per_s_batch64": images_per_s}
    if args.sass is not None:
        result["sass"] = sass_counts(_build.library_path(), args.sass)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
