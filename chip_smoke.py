#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tq_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises and the script exits
non-zero without printing a result:

1. build the CUDA kernels of ``tq_tpu_torch/csrc`` with ``nvcc`` (sm_90a)
   and turn TF32 off;
2. hold every kernel body against its plain PyTorch version on the card:
   ``tr_quantize`` (element-wise and grouped) bit for bit (the element-wise
   body also at every length 1-40, at x 1-7 elements past a 16-byte
   boundary, the output aligned or not, and split into chunks; the
   launchers' stream handle is the current stream's; the grouped body on
   every axis with inner 1, 10 and others, trailing partial groups,
   g = 8, 16 and generic ones, x off 16 bytes and in another layout, its
   output contiguous, and timed at the MLP's and the LSTM's weight
   shapes beside B5 on as many elements; the element-wise body also
   timed at the LSTM's activation shapes), ``term_matmul``
   (f32 mode on float32 weights, quantized and raw input, at M > 8: the
   tensor-core kernel) within
   rtol=1e-5, atol=1e-4*max|ref| (float32 sums in another order); time
   each (CUDA events), beside its bound, the plain version's time and
   ``torch.matmul``;
3. the main path: the two README MNIST MLP sweeps (UQ ``mnist-quant`` and
   TR ``mnist-tr``) and one ``--fixed-linear`` setting through
   ``run_sweep`` on the card, on ``pretrained/mnist_mlp.npz``; accs,
   tmacs and param_bits must equal the JAX package's (``EXPECTED_SWEEPS``),
   every kernel must have launched;
4. the ``--fixed-linear`` setting on the card and through the CPU plain
   path on the same 512 test samples: equal calibrated scales, equal
   quantized layer inputs (but for float32-sum-order boundary flips,
   counted), each layer within atol=1e-4 given the same input, and the
   log-probs of the rows without a flip within atol=1e-4;
5. ``term_matmul``'s other modes (raw input, int8/int16/bf16-stored and
   9-bit packed weights, the bf16 and int8 modes): every combination the
   checks admit against ``term_matmul_ref`` on the card at ragged shapes,
   at the LSTM serving shapes and at small M on the weight-streaming
   kernel (M in {1, 2, STREAM_MAX_M}, N = 2 mod 16, K off a multiple of
   8, unaligned weight data; at M > 8 the f32 mode in every weight
   format on the ``mma`` kernel, the bf16 and int8 modes on the
   ``mma_lp`` kernel, each counted; the int8
   mode bit for bit, the rest within rtol=1e-5, atol=1e-4*max|ref|); the
   M = 1 serving rows timed warm and cold (weight copies past the L2)
   beside bound, plain version and library call; the
   streaming kernel and those above it timed at M in CROSSOVER_M; the f32
   mode's eight narrow variants at (64, 650, 33278) and (128, 784, 512)
   (NARROW_CELLS) on the ``mma`` kernel, bit for bit with it on the same
   weights widened to float32 (times w_sf) where both take one plan,
   timed beside ``torch.matmul`` on the decoded weights and the bound;
   the ``mma_lp`` kernel timed beside the bound, the plain version and
   ``torch.matmul`` / ``torch._int_mm`` at (128, 784, 512), (350, 650,
   2600) and ``bench.py``'s (8192, 2048, 512) (MMA_LP_CELLS);
6. the LSTM LM at full width (650/650/33278, ``lstm_checkpoint``'s seeded
   weights): the README ``lstm-quant`` sweep and one TR setting through
   ``run_sweep`` on the card; tmacs and param_bits equal to the JAX
   package's, ppl within rtol=1e-3 (``EXPECTED_LSTM_SWEEPS``);
7. TR serving generation at full width: ``generate_tr`` with the decoder
   packed 9-bit, int16 and int8 (raw input), and the fixed decoder
   (quantized input) in the bf16 mode (int16 and 9-bit) and the int8 mode,
   100 tokens each; every kernel of the path must launch;
8. the same serving models on the card and on the CPU: equal calibrated
   scales, equal packs, and teacher-forced log-probs over 16 sampled
   tokens, held as in phase 4; tokens/s of the sampler;
9. ``lstm_batch_serving``: greedy sampling at batch 64, 100 steps, from
   the LSTM LM at full width packed as ``bench.py::bench_generate`` packs
   it (u8s, the recurrent weights too), then in int16 with the
   unquantized layer bf16-stored: every product at M = 64 on the mma
   kernel (3 or 5 launches a step, by variant);
   over 16 sampled steps the card's step on the CPU's inputs and its
   free-running log-probs on the rows without a boundary flip against the
   CPU plain path on the same packed model, within atol 1e-4; tokens/s,
   host ms a step and the device's ms a step (CUDA-graph replay);
10. ``cnn_kernels``: ``tr_quantize`` at the ResNet-18 shapes, bit for bit
    against its plain version: the element-wise body on the four
    activation shapes at batch 64 (RESNET_ACTIVATIONS) in float32 and
    bfloat16 (and their int32 variants; the bf16 body also at every q and
    budget for bits 1..9), the grouped body on every converted conv's HWIO
    weight (g=8, axis 2; each shape timed, and a sweep setting's sum);
    ``tr_scale_copy`` (B1's copy ceiling) equal to ``x * sf``; each timed
    (device, eager, plain version) beside its bound, B5 beside
    ``torch.mul``;
11. ``flagship``: the JAX package's ``entry()`` program (TR ResNet-18,
    wb=9, g=8, wt=12, db=9, dt=3, every sf 0.05, batch 16 at 224x224) on
    ``resnet_checkpoint``'s weights, then its bf16 serving mode and the
    int8-packed UQ model (wb=db=7, g=1, wt=7, dt=5) in float32 and
    bfloat16; held layer by layer against the CPU plain path (the
    quantized input exact and the output within LAYER_RTOL on the same
    input; boundary flips counted), the logits within LOGIT_RTOL of the
    CPU's and of the JAX package's (``EXPECTED_CNN``); the int8 forms as
    in ``cnn_zoo`` (``_int8_held``); images/s of each variant and of the
    unquantized forward at batch 64;
12. ``cnn_sweep``: ``evals/cnn.py``'s ``run_sweep('resnet18')`` over the
    published grid (15 settings, 512 synthetic images, batch 64): tmacs,
    avg_terms and params equal to ``results/resnet18-results.json``, the
    flagship setting's 19 calibrated scales equal to the JAX package's
    (or near-ties on the card's histogram);
13. ``zoo_kernels``: ``tr_quantize`` at the rest of the CNN zoo's shapes,
    bit for bit and timed: the element-wise body in float32 and bfloat16
    on VGG's (64, 224, 224, 64) and MobileNet's / EfficientNet's (64, 112,
    112, 96) (swish outputs: signed), at bits 16 with 16 terms on the
    exempt depthwise weights, on squeeze-excite inputs (64, 1, 1, C); the
    grouped body at g = 2 and 32 (its generic instantiation) on (3, 3,
    512, 512) at every alpha of the group-size grid, and at g = 8 on (1,
    1, 1152, 320);
14. ``cnn_zoo``: VGG-16-bn, MobileNet-v2, EfficientNet-b0 and AlexNet at
    224x224 on ``zoo_params``' seeded weights: the flagship's program
    (batch 8) and its bf16 mode, then ``run_sweep`` over the arch's
    published grid on 64 synthetic images; the logits against the JAX
    package's (``EXPECTED_ZOO``) within ZOO_LOGIT_RTOL, each converted conv
    card against CPU within LAYER_RTOL on the same input (boundary flips
    counted), the bf16 mode within 0.2 of the float32 one, the sweep's
    tmacs, avg_terms and params equal to ``results/``, its (9, 8, 12, 9,
    3) scales equal to the JAX package's (or near-ties); then int8
    serving (``pack_cnn`` at UQ wb=db=7, g=1, wt=7, dt=5, every sf 0.05)
    in float32 and bfloat16 at batch 8: B1's int32-output variants bit
    for bit with their plain version and every int8 conv bit for bit
    with a float64 conv on the card (exact: every sum is an integer
    below 2^53), each int8 conv within LAYER_RTOL of the float32 UQ conv
    on the same input, the logits within ZOO_LOGIT_RTOL of the float32
    UQ model's, the bf16 form within 0.2 of the float32 one; images/s of
    every form;
15. ``group_size``: ``evals/group_size.py``'s ``run_grid('resnet18')``
    over all 25 settings (64 synthetic images): tmacs and avg_terms equal
    to ``results/resnet18-group-size-results.json``, the grouped body
    launched at every g > 1;
16. ``tfm_kernels``: B1 (g = 1, bits 5 and 9) and B2 (g = 8, axis 0, bits
    8, 24 terms, read in place; B5 on as many elements) bit for bit on the
    Transformer's weights (650, 650) and (650, 33278), and the streaming
    ``term_matmul`` at (1, 650, 650) and (1, 650, 33278) in its three
    raw-input variants within rtol 1e-5, atol 1e-4 * max|ref|; each timed
    (device warm and cold, eager, plain, ``torch.matmul``) beside its bound;
17. ``tfm_sweep``: the Transformer LM at full width (vocab 33278, emsize
    650, nhead 2, nhid 650, two layers, ``transformer_checkpoint``'s
    seeded weights) through ``run_sweep(model="Transformer")`` over the
    lstm-quant settings and one TR setting: tmacs and param_bits equal to
    the JAX package's, ppl within rtol 1e-3 (``EXPECTED_TFM_SWEEPS``);
18. ``tfm_generation``: the fp32 sampler (the full prefix every token) and
    the TR KV-cache sampler in u8s, int16 and int8, 100 tokens each, every
    raw-input streaming variant launched; each serving model card against
    CPU (equal scales and packs, teacher-forced log-probs over 16 tokens
    within atol 1e-4), ``decode_step`` against the full prefix (1e-5 fp32,
    2e-4 packed); tokens/s;
19. ``tfm_export``: the u8s Transformer ``decode_step`` and the u8s LSTM
    step exported with ``torch.export``, saved, reloaded and run beside
    the direct step over 16 steps (log-probs and carry within 1e-6), the
    streaming kernel (and the LSTM's B1) launched inside the loaded
    program; then each exported on the CPU as a portable artifact
    (``platforms=("cpu", "cuda")``), loaded on the card and on the CPU,
    and held the same way against the card's and the CPU's direct steps;
20. ``st_kernels``: ``term_reveal_st`` (the straight-through op of QAT)
    on the card at (784, 512) g = 1 bits 1, (784, 512) g = 8 axis 0 bits 4
    and a (64, 784) input at bits 6: the forward bit for bit with the
    plain version (one B1 or B2 launch), the backward the upstream
    gradient itself and zero for sf (no launch); timed forward and
    forward plus backward; ``qat_apply`` with quantized inputs, forward
    and backward, card against CPU (boundary flips counted);
21. ``mlp_train``: 20 steps of the MLP trainer (Adadelta, dropout 0) from
    ``mlp_checkpoint``'s seeded weights, card against CPU and against the
    JAX package's (``EXPECTED_TRAIN``) within rtol 1e-4; one full epoch of
    ``train`` on the card, samples/s;
22. ``qat``: 20 steps of ``train_qat``'s recipe at (wb, gs, wt) = (1, 1,
    1) and (4, 8, 6): each card step against the CPU's on the same
    parameters, the free-running losses against the CPU's and the JAX
    package's wherever the term-revealed weights agree (a fingerprint of
    their codes; the rest counted as boundary flips); ``run_demo``;
23. ``lm_train``: 5 chunks of the LSTM (650/650/33278, tied) and the
    Transformer (650/2/650/2/33278) trainers at batch 20, bptt 35, dropout
    0 from the seeded checkpoints, card against CPU and ``EXPECTED_TRAIN``
    within rtol 1e-4, tokens/s; one epoch of ``train`` at dropout 0.2 for
    all five families (GRU and the vanilla RNNs at width 200, lr 5), each
    validation loss below its init's; the trained LSTM and Transformer
    through ``run_sweep`` on the card.  Phases 21-23 are the train path:
    B1 and B2 must launch there, and no plain version of a kernel may run
    on the card;
24. ``empirical``: the empirical term-pair profiler
    (``profilers/empirical.py``) on the flagship model at 224x224, batch
    16: conversion and ``empirical_cnn_cost`` on the card, the capture and
    the counting timed apart, the card's captures counted again on the
    CPU (every pairs, macs and mean count equal), every layer within its
    analytic budget, its deviation from the avg-terms factorization
    printed, and on layer4.1.conv1 the plane-pair map summed equal to the
    count-map total;
25. ``config``: a RunConfig JSON of two README MLP settings through
    ``config.run`` on the card, equal to ``run_sweep`` called directly and
    to EXPECTED_SWEEPS;
26. ``trace``: one flagship forward inside ``utils/trace.device_trace``:
    the Chrome trace's kernel events of each of the port's kernels equal
    its launch counter; where the device time goes, by kernel class;
27. ``viz``: ``layer_errors`` (every converted conv, UQ and TR) and
    ``group_term_counts`` on the card against the CPU; matplotlib never
    imported.  Phases 24-27 are the leaf path (B1 and B2 must launch, no
    plain version on the card);
28. ``oracle``: B1 and B2 on a million elements bit for bit against the
    native C++ oracle (``utils/native.py``) at five (bits, g, budget)
    settings, each timed beside its plain version;
29. ``example``: ``python -m tq_tpu_torch.examples.quantize_resnet18`` at
    224 in its own process: its cost lines and the serving-mode line.
30. ``par``: the port's ``parallel/`` at full width, world 1 over NCCL in
    this process and world 2 over gloo in two ranks sharing the card
    (``parallel/launch.py``; CUDA tensors staged through pinned host
    memory, the bytes printed): the Transformer LM (33278 / 650 / 2 heads
    / 650 / 2 layers, ``transformer_checkpoint``'s weights, u8s) with its
    decoder column-parallel (``make_tp_quantized_apply``) at tokens (35,
    10), raw input on ``mma`` and quantized input on ``mma_lp``, and a
    5-token prompt at batch 1 on the streaming kernel: world 1 bit for bit
    with the unsharded forward, world 2 (shards of 16,639 columns) within
    rtol 1e-5, atol 1e-4 * max|ref| of world 1; ``BatchRunner`` over
    'data' (the LSTM LM packed u8s, 131 requests in batches of 64, 16
    greedy tokens): the rows without a boundary flip within atol 1e-4 of
    world 1, flips counted; at world 2 the four TP functions at (128, 784,
    512) and (350, 650, 2600) in the f32, int8 and bf16 modes against the
    unsharded call (column-parallel int8 bit for bit), the GPipe MLP
    pipeline (forward and gradients) and the TR trunk (B1 every tick)
    against the sequential stages, a DP x TP MLP step on (2, 1) and (1,
    2) against the single-device step, and the sharded checkpoint read
    back bit for bit; then what NCCL says to two ranks on one card;
31. ``par_cells``: ``mma`` (f32_raw_packed8) and ``mma_lp``
    (bf16_packed8) at the decoder's shard (350, 650, 16639) and whole
    (350, 650, 33278), timed here alone beside ``torch.matmul``, the plain
    version and the bound;
32. ``par_examples``: the three parallel examples at ``--world 2``, each
    in its own process, each printing its JAX twin's line;
33. ``par_dryrun``: the rest of the JAX package's multi-device dry run on
    ranks, world 1 (NCCL) and world 2 (two gloo ranks on the card), world
    2 held against world 1: TR ResNet-18 at 224, batch 16, the flagship
    setting, its conv kernels and fc over 'model'
    (``parallel/tp.py::make_tp_cnn_apply``): each conv within LAYER_RTOL
    of the unsharded conv on the same input, the logits within LOGIT_RTOL
    of the unsharded forward's and of world 1's, B1 launched once a
    converted conv a rank (at world 1 B1 on every conv's input and B2 on
    every weight bit for bit against the CPU), VGG-16-bn likewise at batch
    2 (world 2); one ``eval_setting(mesh=)`` of the flagship setting (128
    images at 224, batch 64, labelled by the float model's argmax) over
    'data': tmacs, avg_terms, params and every scale equal to world 1's,
    the accuracy equal to what the gathered predictions give and within
    world 1's near-ties of world 1's, the histograms' counts equal,
    elements moved between bins printed; one
    full-width Transformer step over 'data' (tokens (35, 20), dropout 0):
    loss rtol 1e-5, parameters rtol 1e-4; the GRU LM at 650/650/33278
    (u8s): a quantized eval chunk at (35, 20) within atol 1e-4, 16 greedy
    steps at batch 64 with the flipped rows counted; the Transformer's
    KV-cache decode (u8s, batch 20, 16 steps), rows with a near-tie
    counted; ``term_matmul`` at the decode's shapes against its plain
    version.  The path's launches are those of its own calls only (the
    conversions, the checked forward, the eval, the step, the LM loops):
    the reference runs, checks and timing repeats are not counted;
34. ``histogram``: calibration's histogram kernel bit for bit against its
    plain version (``index_add_``) on ResNet-18's 20 conv inputs at batch
    64 after a ReLU, an all-zero (64, 56, 56, 64), every bin edge with
    NaN, +-inf and -0.0, odd-length views off 16 bytes, a strided 1-D
    view, and 1,024 and 16,384 bins; ``histogram_update`` launches it on a
    float32 CUDA tensor, once a tracked layer in a tracked batch of the
    flagship setting (``resnet_checkpoint``'s weights, 8 images at 224;
    the path's count); timed by CUDA-graph replay beside the bytes bound
    (4 bytes an element), the all-zero input within 3x of the ReLU input
    of its shape (the hot bin does not serialise), and a tracked batch's
    sum.  Every path that calibrates on the card must launch it.

35. ``moe_grouped``: the grouped expert product at the MoE cell's decode
    shapes (64 experts, 2,048 -> 1,408 gate and up in one launch, 1,408
    -> 2,048 down, 384 pairs routed over Zipf-repeated rows) against its
    plain version, with half the experts held and at one row (K split);
    ``moe_apply``'s grouped path against its per-expert path, the
    per-expert launches it replaces counted, the grouped path free of
    host syncs (sync debug mode "error"); each launch timed by
    CUDA-graph replay beside its bytes bound, and a layer call on both
    paths at 64 to 8,192 rows (the crossover ``GROUPED_MAX_PAIRS``
    records); the same checks on a table of 256 router ids with packs
    for 64 held experts alone, at the Kimi cell's decode shapes (2,048
    pairs, 2,304 -> 1,024 and 1,024 -> 2,304), and its refusals.
36. ``lstm_graph``: the LSTM LM's quantized step through its CUDA graph
    (``utils/graphs.py``) at batch 1 and 64 on the serving cells' model:
    20 chained greedy steps bit for bit against the eager step (log-probs,
    h and c); host and wall us a step, eager and replayed; device us a
    step; launches a step equal; the counter (one capture a batch).

Then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Needs one CUDA
device; imports nothing of JAX.  ``--only
mlp|lstm|cnn|zoo|tfm|train|leaf|par|calib|moe`` runs the build and those
groups of phases only (phases 2-5, 6-9 and 36, 10-12, 13-15, 16-19,
20-23, 24-29, 30-33, 34, 35).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark.roofline import HBM_BYTES_PER_S, PEAK_OPS_PER_S

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

# The LSTM LM at the published width (vocab 33278, emsize = nhid = 650, two
# layers, tied decoder) with random weights from LSTM_SEED
# (lstm_checkpoint), on the synthetic Wikitext-2 test stream (20,000
# tokens, batch 10, bptt 35).  ppls, tmacs and param_bits are the JAX
# package's run_sweep on the CPU over the same npz, printed by
# ``python tests/test_torch_port_lstm.py --expected``.
LSTM_SEED = 0
EXPECTED_LSTM_SWEEPS = {
    "lstm-quant": {
        "settings": dict(wb=[5, 6, 7, 8, 9], wt=[5, 6, 7, 8, 9],
                         db=[8] * 5, dt=[8] * 5, gs=[1] * 5),
        "ppls": [33323.98409694335, 33320.229376805226, 33322.31134474884,
                 33322.51413087664, 33321.66407799847],
        "tmacs": [302829800000, 363395760000, 423961720000, 484527680000,
                  545093640000],
        "param_bits": [108153500, 129784200, 151414900, 173045600,
                       194676300],
    },
    "lstm-tr": {
        "settings": dict(wb=[8], wt=[24], db=[8], dt=[8], gs=[8]),
        "ppls": [33321.728110999145],
        "tmacs": [181697880000],
        "param_bits": [301505100],
    },
}

# The Transformer LM at the JAX package's full width (vocab 33278, emsize
# 650, nhead 2, nhid 650, two layers) on transformer_checkpoint(TFM_SEED)'s
# weights, the same synthetic stream and the same two sweeps as the LSTM:
# the README lstm-quant settings and the lstm-tr one.  The JAX package's
# run_sweep(model="Transformer") on the CPU over the same npz, printed by
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_port_transformer
# --expected``.
TFM_SEED = 0
TFM_NHEAD = 2
EXPECTED_TFM_SWEEPS = {
    "lstm-quant": {
        "settings": dict(wb=[5, 6, 7, 8, 9], wt=[5, 6, 7, 8, 9],
                         db=[8] * 5, dt=[8] * 5, gs=[1] * 5),
        "ppls": [38301.12794993621, 38293.68166475003, 38274.1186807632,
                 38283.20693096072, 38277.821040745206],
        "tmacs": [338319800000, 405983760000, 473647720000, 541311680000,
                  608975640000],
        "param_bits": [120828500, 144994200, 169159900, 193325600,
                       217491300],
    },
    "lstm-tr": {
        "settings": dict(wb=[8], wt=[24], db=[8], dt=[8], gs=[8]),
        "ppls": [38283.58097925396],
        "tmacs": [202991880000],
        "param_bits": [340892205],
    },
}

# TR ResNet-18 at 224x224 on resnet_checkpoint(CNN_SEED)'s weights.  The
# flagship program (the JAX package's entry(): wb=9, g=8, wt=12, db=9,
# dt=3, every sf 0.05, batch 16 of numpy normals from seed 0) and one
# published-grid sweep setting's 19 calibrated scales (the first synthetic
# batch of 64), from the JAX package on the CPU, printed by
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_port_cnn --expected``.
CNN_SEED = 0
FLAGSHIP = dict(tr=(9, 8, 12), db=9, dt=3, sf=0.05, batch=16, image=224)
EXPECTED_CNN = {
    "flagship": {
        "top1": [991, 991, 991, 991, 991, 991, 991, 991, 991, 991, 991, 991,
                 991, 991, 991, 991],
        "top2_margin": [1.2176122665405273, 1.355565071105957,
                        1.2299017906188965, 1.2586431503295898,
                        1.2158474922180176, 1.3083209991455078,
                        1.2134041786193848, 1.2625923156738281,
                        1.30244779586792, 1.364241600036621,
                        1.3159265518188477, 1.3355636596679688,
                        1.2823171615600586, 1.2724499702453613,
                        1.2248883247375488, 1.270796775817871],
        "row_max": [7.910977840423584, 7.998993396759033, 7.91911506652832,
                    7.915836334228516, 7.897219181060791, 8.021514892578125,
                    7.901100158691406, 7.932398796081543, 7.895548343658447,
                    7.926361083984375, 8.003985404968262, 8.0343599319458,
                    7.976423740386963, 7.962591648101807, 7.905799388885498,
                    7.94594669342041],
        "first": [-1.9204952716827393, 2.0567221641540527, -3.1713931560516357,
                  -3.13493013381958, 1.4566460847854614, -5.257798194885254,
                  -3.3258249759674072, -2.313128709793091],
        "mean": 0.007910105726507027,
        "std": 2.24322252458872,
        "max_abs": 8.0343599319458,
    },
    "sweep_sf": {
        "setting": [9, 8, 12, 9, 3],
        "sf": {
            "layer1.0.conv1": 0.024425998330116272,
            "layer1.0.conv2": 0.024425998330116272,
            "layer1.1.conv1": 0.024425998330116272,
            "layer1.1.conv2": 0.024425998330116272,
            "layer2.0.conv1": 0.024425998330116272,
            "layer2.0.conv2": 0.024425998330116272,
            "layer2.0.downsample.0": 0.024425998330116272,
            "layer2.1.conv1": 0.024425998330116272,
            "layer2.1.conv2": 0.024425998330116272,
            "layer3.0.conv1": 0.024425998330116272,
            "layer3.0.conv2": 0.024425998330116272,
            "layer3.0.downsample.0": 0.024425998330116272,
            "layer3.1.conv1": 0.024425998330116272,
            "layer3.1.conv2": 0.024425998330116272,
            "layer4.0.conv1": 0.04885198920965195,
            "layer4.0.conv2": 0.024425998330116272,
            "layer4.0.downsample.0": 0.04885198920965195,
            "layer4.1.conv1": 0.04885198920965195,
            "layer4.1.conv2": 0.04885198920965195,
        },
    },
}

# The rest of the CNN zoo at 224x224 on zoo_params(arch, ZOO_SEED)'s
# weights.  The flagship's program (wb=9, g=8, wt=12, db=9, dt=3, every sf
# 0.05) on ZOO_PROGRAM["batch"] images of numpy normals from seed 0, and the
# sweep's (9, 8, 12, 9, 3) scales after its calibration pass (the first
# synthetic batch of 64), in conversion order; AlexNet, which has no
# published file, with its sweep's deterministic columns.  From the JAX
# package on the CPU, printed by
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_port_zoo --expected``.
ZOO_ARCHS = ("vgg16_bn", "mobilenet_v2", "efficientnet_b0", "alexnet")
ZOO_SEED = 0
ZOO_PROGRAM = dict(tr=(9, 8, 12), db=9, dt=3, sf=0.05, batch=8, image=224)
EXPECTED_ZOO = {
    "vgg16_bn": {
        "program": {
            "top1": [795, 795, 795, 480, 795, 795, 795, 416],
            "top2_margin": [0.0022505521774291992, 0.006171766668558121,
                            0.004045501351356506, 0.0019608065485954285,
                            0.0007551982998847961, 0.0005882158875465393,
                            0.0027087144553661346, 9.217113256454468e-05],
            "mean": 5.9606015565805135e-06,
            "std": 0.02221569462975415,
            "max_abs": 0.06998812407255173,
            "row_max": [0.06403996050357819, 0.06824380904436111,
                        0.06349945813417435, 0.06341642886400223,
                        0.06604239344596863, 0.06335555016994476,
                        0.06486225873231888, 0.06377570331096649],
            "first": [0.02200012281537056, 0.0038333176635205746,
                      -0.02646070346236229, 0.010045886039733887,
                      0.002925564767792821, 0.02291811816394329,
                      -0.01078892033547163, 0.008593558333814144],
        },
        "sweep_sf": {
            "setting": [9, 8, 12, 9, 3],
            "sf": [0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272],
        },
    },
    "mobilenet_v2": {
        "program": {
            "top1": [93, 93, 93, 93, 93, 93, 93, 93],
            "top2_margin": [0.043519020080566406, 0.04973435401916504,
                            0.1412501335144043, 0.1106424331665039,
                            0.04167461395263672, 0.07389163970947266,
                            0.026016712188720703, 0.17352056503295898],
            "mean": -0.08448403856196092,
            "std": 1.137211361978146,
            "max_abs": 4.7612690925598145,
            "row_max": [3.441467046737671, 3.3802199363708496,
                        3.3894753456115723, 3.4560964107513428,
                        3.424201488494873, 3.4011783599853516,
                        3.4526467323303223, 3.551295757293701],
            "first": [0.37782421708106995, 0.9904072284698486,
                      -1.6237306594848633, 2.1398987770080566,
                      -1.4976638555526733, 1.8762035369873047,
                      -0.4931541681289673, -2.539684772491455],
        },
        "sweep_sf": {
            "setting": [9, 8, 12, 9, 3],
            "sf": [0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.04885198920965195,
                   0.024425998330116272, 0.07327798008918762,
                   0.07327798008918762, 0.07327798008918762,
                   0.07327798008918762, 0.07327798008918762,
                   0.07327798008918762, 0.07327798008918762,
                   0.04885198920965195, 0.07327798008918762,
                   0.07327798008918762, 0.0977039635181427,
                   0.07327798008918762, 0.07327798008918762,
                   0.07327798008918762, 0.07327798008918762,
                   0.07327798008918762, 0.04885198920965195,
                   0.07327798008918762, 0.07327798008918762,
                   0.07327798008918762, 0.07327798008918762,
                   0.07327798008918762, 0.0977039635181427,
                   0.07327798008918762, 0.07327798008918762,
                   0.07327798008918762],
        },
    },
    "efficientnet_b0": {
        "program": {
            "top1": [858, 858, 858, 858, 858, 858, 858, 858],
            "top2_margin": [0.00014466047286987305, 0.00014466047286987305,
                            0.00014466047286987305, 0.00014466047286987305,
                            0.00014466047286987305, 0.00014466047286987305,
                            0.00014466047286987305, 0.00014466047286987305],
            "mean": 0.001162176468141297,
            "std": 0.016327123941501986,
            "max_abs": 0.02792540192604065,
            "row_max": [0.02785356715321541, 0.02785356715321541,
                        0.02785356715321541, 0.02785356715321541,
                        0.02785356715321541, 0.02785356715321541,
                        0.02785356715321541, 0.02785356715321541],
            "first": [0.02033214084804058, -0.008804664947092533,
                      -0.021292291581630707, 0.015325016342103481,
                      -0.01838327944278717, 0.0015641999198123813,
                      -0.02250843495130539, 0.016879979521036148],
        },
        "sweep_sf": {
            "setting": [9, 8, 12, 9, 3],
            "sf": [0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 9.99999993922529e-09,
                   9.99999993922529e-09, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   0.024425998330116272, 0.024425998330116272,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 0.024425998330116272,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   0.024425998330116272, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 0.024425998330116272,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09,
                   9.99999993922529e-09, 9.99999993922529e-09],
        },
    },
    "alexnet": {
        "program": {
            "top1": [177, 177, 814, 177, 177, 177, 814, 177],
            "top2_margin": [0.0021944046020507812, 0.003735944628715515,
                            0.001955285668373108, 0.01077444851398468,
                            0.0013228356838226318, 0.012300118803977966,
                            0.0027742087841033936, 0.006500869989395142],
            "mean": 0.0002687962944437459,
            "std": 0.04406743969722684,
            "max_abs": 0.14910674095153809,
            "row_max": [0.1368844360113144, 0.13570944964885712,
                        0.14301255345344543, 0.14244745671749115,
                        0.14294695854187012, 0.14437726140022278,
                        0.14252695441246033, 0.14910674095153809],
            "first": [0.08439035713672638, 0.027090908959507942,
                      0.03425776585936546, -0.0711604505777359,
                      -0.0009975321590900421, -0.018901046365499496,
                      0.019578658044338226, 0.08336549252271652],
        },
        "sweep_sf": {
            "setting": [9, 8, 12, 9, 3],
            "sf": [0.024425998330116272, 0.024425998330116272,
                   0.024425998330116272, 0.024425998330116272],
        },
        "columns": {
            "quant": {
                "tmacs": [31605645312.0, 36873252864.0, 42140860416.0,
                          47408467968.0],
                "avg_terms": [9.0, 9.0, 9.0, 9.0],
                "params": [61100840.0, 61100840.0, 61100840.0, 61100840.0],
            },
            "tr-data2": {
                "tmacs": [1755869184.0, 2341158912.0, 2926448640.0,
                          3511738368.0],
                "avg_terms": [1.5, 2.0, 2.5, 3.0],
                "params": [61100840.0, 61100840.0, 61100840.0, 61100840.0],
            },
            "tr-data3": {
                "tmacs": [2633803776.0, 3511738368.0, 4389672960.0,
                          5267607552.0],
                "avg_terms": [1.5, 2.0, 2.5, 3.0],
                "params": [61100840.0, 61100840.0, 61100840.0, 61100840.0],
            },
            "tr-data4": {
                "tmacs": [3511738368.0, 4682317824.0, 5852897280.0,
                          7023476736.0],
                "avg_terms": [1.5, 2.0, 2.5, 3.0],
                "params": [61100840.0, 61100840.0, 61100840.0, 61100840.0],
            },
        },
    },
}

# The bounds are stated against the benchmark's peaks of one H100 SXM
# (benchmark/roofline.py: HBM_BYTES_PER_S, PEAK_OPS_PER_S), beside the
# card's name and power limit.

# ResNet-18's activation shapes at batch 64 (NHWC): the inputs of layer1 to
# layer4's convs, where the converted convs run B1.
RESNET_ACTIVATIONS = [(64, 56, 56, 64), (64, 28, 28, 128), (64, 14, 14, 256),
                      (64, 7, 7, 512)]

KERNELS = {
    "tr_quantize_elementwise": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:192"),
    "tr_quantize_elementwise_bf16": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:192"),
    # B1's int32-output variants (tr_quantize_int): the int8 convs' input
    # codes (pack_cnn's models in float32 and bfloat16) and the LSTM
    # decoder's wide-N integer route.
    "tr_quantize_elementwise_int": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:192"),
    "tr_quantize_elementwise_bf16_int": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:192"),
    "tr_quantize_grouped": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:205"),
    # No TPU kernel: the JAX package counts with .at[].add.  Calibration's
    # histograms of float32 CUDA inputs; held and timed in phase histogram.
    "histogram": dict(
        route="cuda", source="tq_tpu_torch/csrc/histogram.cu",
        replaces="none (tq_tpu/layers/quantize.py:56, .at[idx].add)"),
    # No user path runs B5 (the JAX package calls it from bench.py alone):
    # it is B1's copy ceiling, held and timed in phase cnn_kernels.
    "tr_scale_copy": dict(
        route="cuda", source="tq_tpu_torch/csrc/tr_quantize.cu",
        replaces="tq_tpu/kernels/tr_quantize.py:246", on_main_path=False),
    # term_matmul's f32 mode at M > STREAM_MAX_M, on the tensor cores: on
    # float32 weights (the MLP eval) and on int8, int16, bf16-stored and
    # 9-bit packed weights (the batch-64 LSTM serving step, phase
    # lstm_batch_serving).
    "term_matmul_kernel_mma": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_mma.cu",
        replaces="tq_tpu/kernels/term_matmul.py:264"),
    # The bf16 and int8 modes at M > STREAM_MAX_M, on the tensor cores.
    # Held in phase term_matmul_modes (every variant) and timed there;
    # its path is group par's (the
    # column-parallel decoder's quantized input, the TP int8 and bf16
    # products), timed there at the decoder's shard shape.
    "term_matmul_kernel_mma_lp": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_mma_lp.cu",
        replaces="tq_tpu/kernels/term_matmul.py:264"),
    # No TPU kernel: the JAX package runs a term_matmul an expert.  The
    # MoE cell's expert layer in a decode step, every expert a launch;
    # held and timed in phase moe_grouped.
    "term_matmul_kernel_grouped": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_grouped.cu",
        replaces="none (one tq_tpu/kernels/term_matmul.py call an expert)"),
    "term_matmul_raw_packed8": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_stream.cu",
        replaces="tq_tpu/kernels/term_matmul.py:151"),
    "term_matmul_raw_int16": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_stream.cu",
        replaces="tq_tpu/kernels/term_matmul.py:219"),
    "term_matmul_raw_int8": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_stream.cu",
        replaces="tq_tpu/kernels/term_matmul.py:219"),
    "term_matmul_bf16_int16": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_stream.cu",
        replaces="tq_tpu/kernels/term_matmul.py:202"),
    "term_matmul_bf16_packed8": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_stream.cu",
        replaces="tq_tpu/kernels/term_matmul.py:237"),
    "term_matmul_int8": dict(
        route="cuda", source="tq_tpu_torch/csrc/term_matmul_stream.cu",
        replaces="tq_tpu/kernels/term_matmul.py:253"),
}
# Kernel row -> term_matmul's launch-counter key (its VARIANTS): the
# serving rows, on the streaming kernel at M = 1.
TERM_MATMUL_ROWS = {
    "term_matmul_raw_packed8": "f32_raw_packed8",
    "term_matmul_raw_int16": "f32_raw_int16",
    "term_matmul_raw_int8": "f32_raw_int8",
    "term_matmul_bf16_int16": "bf16_int16",
    "term_matmul_bf16_packed8": "bf16_packed8",
    "term_matmul_int8": "int8_int8",
}
PEAK_OPS = {"f32": PEAK_OPS_PER_S["fp32"], "bf16": PEAK_OPS_PER_S["bf16"],
            "int8": PEAK_OPS_PER_S["int8"]}

# TR serving generation: (name, (wb, gs, wt, db, dt), pack, fixed decoder).
# The fixed decoder quantizes its input, so its packed weights take the
# bf16 mode (8-bit grids) or the int8 mode (int8 weights, db <= 7).
GEN_CONFIGS = [
    ("u8s", (8, 8, 24, 8, 8), "u8s", False),
    ("int16", (8, 8, 24, 8, 8), "int", False),
    ("int8", (7, 8, 12, 7, 3), "int", False),
    ("fixed-bf16-int16", (8, 8, 24, 8, 3), "int", True),
    ("fixed-bf16-u8s", (8, 8, 24, 8, 3), "u8s", True),
    ("fixed-int8", (7, 8, 12, 7, 3), "int", True),
]
# The train group: the trainers' first steps from seeded npz inits
# (``mlp_checkpoint``, ``lstm_checkpoint``, ``transformer_checkpoint``) at
# dropout 0, held against the JAX package's steps (``EXPECTED_TRAIN``).
TRAIN_SEED = 0
TRAIN_STEPS = 20       # MLP and QAT steps, batch 64
TRAIN_ORDER_SEED = 1   # train()'s default seed: its batch order
QAT_SETTINGS = {"qat_1_1_1": (1, 1, 1, 6, 6),   # (wb, gs, wt, db, dt)
                "qat_4_8_6": (4, 8, 6, 6, 6)}
LM_CHUNKS = 5          # batch 20, bptt 35, lr 20, clip 0.25
LM_BATCH, LM_BPTT, LM_LR, LM_CLIP = 20, 35, 20.0, 0.25
# The JAX package's losses on the CPU from the same npz inits and batches
# (and, for QAT, the fingerprints of the weight codes each step multiplies,
# ``code_fingerprint``): MLP and QAT from
#   JAX_PLATFORMS=cpu python -m tests.test_torch_port_train --expected
# (the recipes of ``train`` / ``train_qat`` composed from ``mlp.apply``,
# ``qat_apply``, ``nll_loss`` and optax), the LMs from
#   JAX_PLATFORMS=cpu python -m tests.test_torch_port_train_lm --expected
# (``tq_tpu.evals.train_lstm._train_step`` / ``_train_step_transformer``).
EXPECTED_TRAIN = {
    "mlp": {
        "losses": [
            2.340346336364746, 2.1422595977783203, 2.26145339012146,
            2.538465976715088, 2.0869035720825195, 1.910818099975586,
            2.683718204498291, 2.5247631072998047, 1.7177691459655762,
            1.2656594514846802, 1.7482414245605469, 2.2535643577575684,
            2.2622923851013184, 3.509107828140259, 2.2515196800231934,
            1.3436834812164307, 1.0503469705581665, 0.9075230360031128,
            0.7390603423118591, 0.8014461398124695],
    },
    "qat_1_1_1": {
        "losses": [
            2.3923234939575195, 2.063591718673706, 1.9947314262390137,
            1.558609962463379, 1.3547056913375854, 1.0227080583572388,
            0.7864927053451538, 0.51963210105896, 0.275044322013855,
            0.22162574529647827, 0.15847274661064148, 0.0850851833820343,
            0.05594148486852646, 0.04343414306640625, 0.017537269741296768,
            0.009128954261541367, 0.010488063097000122, 0.010341886430978775,
            0.004144440405070782, 0.010413908399641514],
        "codes": [
            [-463108395229, 460702790470, 31923348662], [-1175578622030,
            476811512392, -4647581955], [-1792392918069, 506360649183,
            -28635709728], [-2460937086678, 406974438536, -53172598404],
            [-2636250073021, 434354493939, -53290784265], [-2277690761247,
            481992971806, -53429745047], [-1395765888752, 759435021380,
            -52836125736], [-495781730680, 996063694063, -66377342834],
            [289574325799, 1184812572304, -81128786898], [1142533397438,
            1425567053785, -85795054081], [1848070540337, 1752681347317,
            -89842853176], [2678691343774, 1972196696508, -111610646502],
            [3448164095642, 2080129215454, -97033343379], [4104331266810,
            2244358386352, -98430698089], [4725762641633, 2392330249283,
            -106335630731], [5300247588525, 2659714573344, -107022163258],
            [5480016022339, 2769551872181, -110662552091], [5744121591669,
            2967555619699, -117192259056], [5938150562062, 3089937795260,
            -130157405676], [6110853041706, 3112860785480, -133667623000]],
    },
    "qat_4_8_6": {
        "losses": [
            2.3559975624084473, 2.125419855117798, 2.100918769836426,
            1.6072494983673096, 1.5448088645935059, 1.1676900386810303,
            0.9730697870254517, 0.6599692106246948, 0.38821548223495483,
            0.3297141194343567, 0.2674213647842407, 0.16160708665847778,
            0.1335744708776474, 0.057832181453704834, 0.038100920617580414,
            0.040834181010723114, 0.04981238394975662, 0.041166238486766815,
            0.021615803241729736, 0.021954061463475227],
        "codes": [
            [-3637638243627, 5454162064611, 11015531161], [-8577830907918,
            4841955631257, -9786361666], [-10171130560722, 5200345954268,
            -145179652834], [-11530150502788, 5430605211008, -220709019383],
            [-9082964185235, 5609714920932, -325612910205], [-1697506259724,
            7024575137110, -485695250378], [7298147078780, 9302370871601,
            -532030256946], [15549396382313, 12157802154230, -619868537384],
            [21874039440305, 15262156701126, -819792079707], [28131743620337,
            18861363636065, -920225725910], [33447193365273, 21164508929230,
            -961590098391], [38487811063815, 22492374183022, -1003389621208],
            [42876449956450, 23974023286731, -1050199365169], [45425426041273,
            24989736295863, -1116160920789], [49104796253309, 25864018668604,
            -1103629863938], [51692861140263, 26294932143247, -1086318521931],
            [53657062685800, 27699468042434, -1070441905051], [55115478871150,
            28109811936633, -1128513833797], [56121836838225, 29022305170276,
            -1140643396505], [57037409549470, 29704467355745, -1117736224703]],
    },
    "lstm": {
        "losses": [
            10.41455364227295, 9.789587020874023, 23.250526428222656,
            9.758983612060547, 11.971420288085938],
    },
    "transformer": {
        "losses": [
            10.561786651611328, 17.414812088012695, 17.80320930480957,
            9.969773292541504, 13.494918823242188],
    },
}

GEN_WORDS = 100
GEN_SEED = 1111
# Chained steps held bit for bit, graph against eager (phase lstm_graph).
GEN_STEPS = 20
TEACHER_TOKENS = 16
VOCAB = 33278


def mlp_checkpoint(path, seed: int = TRAIN_SEED) -> None:
    """Save random MNIST MLP weights made with numpy from ``seed``, in
    ``mlp.init``'s distributions (every weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), weights stored (in, out)), with the port's
    ``save_params``: the same file loads in both packages."""
    from tq_tpu_torch.models.mlp import DIMS, LAYER_NAMES
    from tq_tpu_torch.utils.checkpoint import save_params

    rng = np.random.default_rng(seed)
    params = {}
    for name, (fan_in, fan_out) in zip(LAYER_NAMES, DIMS):
        bound = 1.0 / np.sqrt(fan_in)
        params[name] = {
            "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(
                np.float32),
            "b": rng.uniform(-bound, bound, fan_out).astype(np.float32)}
    save_params(path, params)


def code_fingerprint(q) -> int:
    """An integer hash of an integer array (the term-revealed codes of a
    weight): sum of q[i] * c[i] over a fixed sequence c of odd-looking
    integers in [1, 2^31], exact in int64.  Equal arrays give equal hashes;
    one differing code always changes it."""
    q = np.asarray(q).reshape(-1).astype(np.int64)
    c = (np.arange(q.size, dtype=np.int64) * 2654435761) % (1 << 31) + 1
    return int((q * c).sum())


def qat_fingerprints(torch, params, setting) -> list:
    """Per MLP layer, :func:`code_fingerprint` of the weight codes
    ``qat_apply`` multiplies at ``setting`` (wb, gs, wt, ...), computed on
    the CPU by the plain version (no kernel launch)."""
    from tq_tpu_torch.evals.qat_mlp import _st_scale
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.models.mlp import LAYER_NAMES

    wb, gs, wt = setting[:3]
    out = []
    with torch.no_grad():
        for name in LAYER_NAMES:
            w = params[name]["w"].detach().cpu()
            sf = _st_scale(w, wb)
            q = torch.round(tr_quantize(w, sf, wb, gs, wt, 0) / sf)
            out.append(code_fingerprint(q.numpy()))
    return out


def lstm_checkpoint(path, seed: int = LSTM_SEED, vocab: int = 33278,
                    emsize: int = 650, nhid: int = 650,
                    nlayers: int = 2) -> None:
    """Save random LSTM LM weights made with numpy from ``seed``, in
    ``lstm_lm.init``'s distributions (encoder U(-0.1, 0.1), recurrent
    U(-1/sqrt(H), 1/sqrt(H)), decoder bias 0, tied), with the port's
    ``save_params``: the same file loads in both packages."""
    from tq_tpu_torch.utils.checkpoint import save_params

    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(nhid)

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)

    params = {"encoder": {"w": uniform((vocab, emsize), 0.1)}, "rnn": []}
    for i in range(nlayers):
        params["rnn"].append({
            "w_ih": uniform((emsize if i == 0 else nhid, 4 * nhid), k),
            "w_hh": uniform((nhid, 4 * nhid), k),
            "b_ih": uniform((4 * nhid,), k),
            "b_hh": uniform((4 * nhid,), k)})
    params["decoder"] = {"b": np.zeros(vocab, np.float32)}
    save_params(path, params)


def transformer_checkpoint(path, seed: int = TFM_SEED, vocab: int = 33278,
                           emsize: int = 650, nhid: int = 650,
                           nlayers: int = 2) -> None:
    """Save random Transformer LM weights made with numpy from ``seed``, in
    ``transformer_lm.init``'s distributions (encoder U(-0.1, 0.1), every
    dense weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) stored (in,
    out), layer norms at scale 1, bias 0), with the port's
    ``save_params``: the same file loads in both packages."""
    from tq_tpu_torch.utils.checkpoint import save_params

    rng = np.random.default_rng(seed)

    def dense(fi, fo):
        bound = 1.0 / np.sqrt(fi)
        return {"w": rng.uniform(-bound, bound, (fi, fo)).astype(np.float32),
                "b": rng.uniform(-bound, bound, fo).astype(np.float32)}

    def norm():
        return {"scale": np.ones(emsize, np.float32),
                "bias": np.zeros(emsize, np.float32)}

    params = {"encoder": {"w": rng.uniform(-0.1, 0.1, (vocab, emsize))
                          .astype(np.float32)}}
    for i in range(nlayers):
        pre = f"transformer_encoder.layers.{i}"
        params[f"{pre}.self_attn.in_proj"] = dense(emsize, 3 * emsize)
        params[f"{pre}.self_attn.out_proj"] = dense(emsize, emsize)
        params[f"{pre}.linear1"] = dense(emsize, nhid)
        params[f"{pre}.linear2"] = dense(nhid, emsize)
        params[f"{pre}.norm1"] = norm()
        params[f"{pre}.norm2"] = norm()
    params["decoder"] = dense(emsize, vocab)
    save_params(path, params)


def resnet_checkpoint(path, seed: int = CNN_SEED) -> None:
    """Save random ResNet-18 weights made with numpy from ``seed``, in
    ``resnet.init``'s distributions (Kaiming-normal fan-out HWIO convs, BN
    at scale 1, bias 0, mean 0, var 1, uniform ``fc``), with the port's
    ``save_params``: the same file loads in both packages."""
    from tq_tpu_torch.models.resnet import conv_specs, dense_specs
    from tq_tpu_torch.utils.checkpoint import save_params

    rng = np.random.default_rng(seed)
    params = {}
    for s in conv_specs():
        std = np.sqrt(2.0 / (s.kh * s.kw * s.out_ch // s.groups))
        params[s.name] = {"w": (rng.normal(size=(
            s.kh, s.kw, s.in_ch // s.groups, s.out_ch)) * std).astype(
                np.float32)}
        bn = (s.name[:-1] + "1" if s.name.endswith("downsample.0")
              else s.name.replace("conv", "bn"))
        params[bn] = {"scale": np.ones(s.out_ch, np.float32),
                      "bias": np.zeros(s.out_ch, np.float32),
                      "mean": np.zeros(s.out_ch, np.float32),
                      "var": np.ones(s.out_ch, np.float32)}
    for name, fan_in, fan_out in dense_specs():
        bound = 1.0 / np.sqrt(fan_in)
        params[name] = {
            "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(
                np.float32),
            "b": rng.uniform(-bound, bound, fan_out).astype(np.float32)}
    save_params(path, params)


def zoo_params(arch: str, seed: int = ZOO_SEED) -> dict:
    """Random weights of the CNN ``arch`` made with numpy from ``seed``, in
    its ``init``'s distributions (Kaiming-normal fan-out HWIO convs over
    their groups, zero conv biases, BN at scale 1, bias 0, mean 0, var 1,
    uniform dense layers), as numpy arrays in the model's tree."""
    import torch

    from tq_tpu_torch.evals.cnn import get_model

    m = get_model(arch)
    groups = {s.name: s.groups for s in m.conv_specs()}
    rng = np.random.default_rng(seed)
    params = {}
    for name, leaves in m.init(torch.Generator(), device="meta").items():
        if "scale" in leaves:
            n = leaves["scale"].shape[0]
            params[name] = {"scale": np.ones(n, np.float32),
                            "bias": np.zeros(n, np.float32),
                            "mean": np.zeros(n, np.float32),
                            "var": np.ones(n, np.float32)}
        elif leaves["w"].ndim == 4:
            kh, kw, _, out = leaves["w"].shape
            std = np.sqrt(2.0 / (kh * kw * out // groups[name]))
            params[name] = {"w": (rng.normal(size=leaves["w"].shape) * std)
                            .astype(np.float32)}
            if "b" in leaves:
                params[name]["b"] = np.zeros(out, np.float32)
        else:
            fan_in, fan_out = leaves["w"].shape
            bound = 1.0 / np.sqrt(fan_in)
            params[name] = {
                "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(
                    np.float32),
                "b": rng.uniform(-bound, bound, fan_out).astype(np.float32)}
    return params


def zoo_checkpoint(arch: str, path, seed: int = ZOO_SEED) -> None:
    """Save :func:`zoo_params` with the port's ``save_params``: the same
    file loads in both packages."""
    from tq_tpu_torch.utils.checkpoint import save_params

    save_params(path, zoo_params(arch, seed))


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
    CUDA graph and replayed, so no host time between launches counts.
    ``fn`` may be a list of functions, called in turn (at least once each):
    each on its own copy of the operands, so that together they exceed
    the L2 cache and every call finds its operands in HBM (cold)."""
    fns = fn if isinstance(fn, list) else [fn]
    calls = max(calls, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for f in fns * (3 if len(fns) == 1 else 1):
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
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


def bound_ms(nbytes: float, flops: float,
             peak: float = PEAK_OPS_PER_S["fp32"]) -> tuple[float, str]:
    """The least time for the work: bytes moved or operations done (at
    ``peak`` operations per second)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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
          # each nvcc (started together) and the link, seconds from start
          "compile_seconds": dict(_build.compile_seconds),
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


def _elementwise_edges(torch, exact, dev) -> dict:
    """The element-wise grid's edges, bit for bit against the plain
    version, for float32 and bfloat16 input, dequantized and int32 output,
    both keep modes (bits 9, 3 terms): every length 1-40 and 2^20 + 29,
    and x starting 1-3 (float32) or 1-7 (bfloat16) elements past a
    16-byte boundary with the output aligned, as far past one (the
    vectors start after a head of single elements), and one element
    further (no vectors), at lengths that go one element a thread (40,
    1,029) and one that takes vectors (2^20 + 29)."""
    from tq_tpu_torch.kernels import tr_quantize as tk

    sf = torch.tensor(0.0371, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    base = _boundary_inputs(torch, 9, 0.0371, dev)
    base = base[torch.randperm(base.numel(), generator=gen, device=dev)]
    long = 2**20 + 29
    base = base.repeat(-(-(long + 8) // base.numel()))
    cases, routes = 0, {"vectors": 0, "head": 0, "singles": 0}
    for dtype in (torch.float32, torch.bfloat16):
        src = base.to(dtype)
        per16 = 16 // src.element_size()
        for int_out in (False, True):
            odt = torch.int32 if int_out else dtype
            out_per16 = 16 // (4 if int_out else src.element_size())
            for mode in ("largest", "serial"):
                def check(x, out, what):
                    got = tk._launch_elementwise(x, sf, 9, 3, mode, int_out,
                                                 out=out)
                    p = tk._plan_for(x, got, 0)
                    routes["singles" if p.vec == 1 else
                           "head" if p.head else "vectors"] += 1
                    want = (tk.tr_quantize_int_ref(x, sf, 9, 3, mode)
                            if int_out else tk.tr_quantize_ref(
                                x, sf, 9, 1, 3, keep_mode=mode))
                    exact(f"elementwise {dtype} int_out={int_out} {mode} "
                          f"{what}", got, want)

                for n in (*range(1, 41), long):
                    check(src[:n], None, f"length {n}")
                for k in range(1, per16):
                    for n in (40, 1029, long):
                        x = src[k:k + n]
                        check(x, None, f"x +{k}, length {n}, out aligned")
                        for ko in (k % out_per16, k % out_per16 + 1):
                            buf = torch.empty(n + out_per16 + 1, dtype=odt,
                                              device=dev)
                            check(x, buf[ko:ko + n],
                                  f"x +{k}, length {n}, out +{ko}")
                cases += 41 + (per16 - 1) * 3 * 3
    for route, n in routes.items():
        if n == 0:
            fail(f"elementwise edges: no case took the {route} route")
    # A launch past tk._CHUNK elements is split (its vectors index in 32
    # bits): the split, at a chunk of 2^19, on x 0-3 floats off 16 bytes:
    # two chunks of vectors and one of 5 single elements.
    chunk, tk._CHUNK = tk._CHUNK, 2**19
    try:
        for k in range(4):
            x = base[k:k + 2**20 + 5]
            before = tk.tr_quantize.launches["elementwise"]
            exact(f"elementwise x +{k}, in chunks of 2^19",
                  tk.tr_quantize(x, sf, 9, 1, 3), tk.tr_quantize_ref(
                      x, sf, 9, 1, 3))
            if tk.tr_quantize.launches["elementwise"] != before + 3:
                fail("elementwise: 2^20 + 5 elements in chunks of 2^19 did "
                     "not take 3 launches")
            cases += 1
    finally:
        tk._CHUNK = chunk
    # The launchers' stream handle is the current stream's.
    from tq_tpu_torch.kernels import _build
    for s in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(s):
            if _build.stream(base.device) != s.cuda_stream:
                fail("kernels._build.stream is not the current stream")
    return dict(cases=cases, routes=routes)


def phase_kernels(torch):
    from tq_tpu_torch.kernels import term_matmul as tm_mod
    from tq_tpu_torch.kernels.term_matmul import (launch, term_matmul,
                                                  term_matmul_ref)
    from tq_tpu_torch.kernels.tr_quantize import (max_hese_terms, tr_quantize,
                                                  tr_quantize_int,
                                                  tr_quantize_int_ref,
                                                  tr_quantize_ref,
                                                  tr_scale_copy)
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
    edges = _elementwise_edges(torch, exact, dev)
    # ... and at the LSTM's activations (bits 9, 3 terms): the serving
    # generator's, one layer's h or c at the sweep's batch 10, a 35-step
    # chunk's embeddings.
    lstm_shapes = {}
    for shape in [(1, 650), (10, 650), (350, 650)]:
        x = randn(*shape, scale=2.0)
        s5 = torch.tensor(0.05, device=dev)
        exact(f"elementwise {shape}", tr_quantize(x, s5, 9, 1, 3),
              tr_quantize_ref(x, s5, 9, 1, 3))
        lstm_shapes["x".join(map(str, shape))] = dict(
            **timings(torch, lambda: tr_quantize(x, s5, 9, 1, 3),
                      lambda: tr_quantize_ref(x, s5, 9, 1, 3)),
            bound_ms=bound_ms(8 * x.numel(), 0)[0])
    results["tr_quantize_elementwise"] = dict(
        cases=n_cases + edges["cases"], edge_routes=edges["routes"],
        shape=[784, 512],
        max_abs_err=float((out - ref).abs().max()),
        **timings(torch, lambda: tr_quantize(w1, sf, 6, 1, 6),
                  lambda: tr_quantize_ref(w1, sf, 6, 1, 6)),
        bound_ms=b, bound_by=by, per_shape=lstm_shapes)

    # tr_quantize grouped, read in place as (outer, n, inner): the grouping
    # axis last (inner 1) and not, inner 10, trailing partial groups on a
    # non-last axis, g = 8 and 16 and generic ones, 16-byte vectors of 4
    # columns a thread (inner % 4 == 0) and one column.
    n_cases = 0
    cases = [((24, 64), 9, 8, 12, -1), ((24, 64), 9, 8, 24, -1),
             ((24, 64), 4, 16, 14, -1), ((24, 64), 8, 2, 3, -1),
             ((24, 64), 9, 32, 32, -1), ((24, 64), 16, 8, 16, -1),
             ((3, 50), 8, 16, 20, -1), ((37, 70), 16, 32, 40, 0),
             ((64, 32, 3, 3), 9, 8, 16, 1), ((5, 101), 6, 2, 1, 1),
             ((784, 512), 4, 16, 6, 0), ((784, 512), 4, 16, 14, 0),
             ((512, 10), 4, 16, 10, 0), ((300, 7), 16, 32, 0, 0),
             ((5, 19, 10), 9, 8, 5, 1), ((5, 19, 10), 9, 16, 30, 1),
             ((5, 19, 10), 9, 7, 9, 1), ((3, 3, 20, 12), 9, 8, 12, 2),
             ((3, 3, 20, 12), 9, 16, 20, 2), ((650, 2600), 8, 8, 24, 0),
             ((100, 64), 24, 31, 60, 0), ((2, 45, 64), 1, 3, 2, 1)]
    for shape, bits, g, k, axis in cases:
        x = randn(*shape)
        # ... and the same values in a view off 16 bytes, and in another
        # layout (first and last axes swapped in memory)
        off = torch.empty(x.numel() + 1, device=dev)[1:].view(shape)
        off.copy_(x)
        xt = x.transpose(0, -1).contiguous().transpose(0, -1)
        sf = weight_scale(x, bits)
        for mode in ("largest", "serial"):
            ref = tr_quantize_ref(x, sf, bits, g, k, axis, mode)
            for name, xs in (("", x), (" off 16 bytes", off),
                             (" transposed", xt)):
                got = tr_quantize(xs, sf, bits, g, k, axis, mode)
                exact(f"grouped {shape}{name} bits={bits} g={g} k={k} "
                      f"{mode}", got, ref)
                if not got.is_contiguous():
                    fail(f"grouped {shape}{name}: the output is not "
                         "contiguous")
                n_cases += 1
    sf = weight_scale(w1, 4)
    out = tr_quantize(w1, sf, 4, 16, 6, 0)
    ref = tr_quantize_ref(w1, sf, 4, 16, 6, 0)
    b, by = bound_ms(8 * n, 6 * n)
    # The MLP's other weights and the LSTM's (the g = 8 setting), timed
    # beside their bound and B5 on as many elements (the copy ceiling);
    # the tied decoder comes as the encoder's transpose.
    per_shape = {}
    for shape, bits, g, k, transposed in [
            ((784, 512), 4, 16, 6, False), ((512, 512), 4, 16, 6, False),
            ((512, 10), 4, 16, 6, False), ((650, 2600), 8, 8, 24, False),
            ((650, 33278), 8, 8, 24, True)]:
        x = randn(*shape[::-1], scale=0.05).T if transposed \
            else randn(*shape, scale=0.05)
        xc = x.contiguous()
        wsf = weight_scale(x, bits)
        exact(f"grouped {shape} bits={bits} g={g} k={k}",
              tr_quantize(x, wsf, bits, g, k, 0),
              tr_quantize_ref(x, wsf, bits, g, k, 0))
        per_shape["x".join(map(str, shape))] = dict(
            group_size=g, bits=bits, terms=k, transposed=transposed,
            **timings(torch, lambda: tr_quantize(x, wsf, bits, g, k, 0),
                      lambda: tr_quantize_ref(x, wsf, bits, g, k, 0)),
            copy_ceiling_ms=device_ms(torch, lambda: tr_scale_copy(xc, wsf)),
            bound_ms=bound_ms(8 * x.numel(), 0)[0])
    results["tr_quantize_grouped"] = dict(
        cases=n_cases, shape=[784, 512], group_size=16,
        max_abs_err=float((out - ref).abs().max()),
        **timings(torch, lambda: tr_quantize(w1, sf, 4, 16, 6, 0),
                  lambda: tr_quantize_ref(w1, sf, 4, 16, 6, 0)),
        copy_ceiling_ms=per_shape["784x512"]["copy_ceiling_ms"],
        bound_ms=b, bound_by=by, per_shape=per_shape)

    # term_matmul f32 on float32 weights at M > STREAM_MAX_M, on the mma
    # kernel (the route), beside the raw input (f32 - f32_raw is the
    # term-reveal's cost) and torch.matmul:
    # the fixed-linear eval shapes at batch 128 and at the last batch of
    # 16, a ragged one, the LSTM chunk (350 rows), and the smallest M the
    # kernel takes with x rows of 2,600 bytes (no 16-byte copies).
    per_shape = {}
    for M, K, N in [(128, 784, 512), (128, 512, 512), (128, 512, 10),
                    (77, 300, 45), (350, 650, 2600), (16, 784, 512),
                    (16, 512, 10), (9, 650, 2600)]:
        x = randn(M, K).relu()
        w = randn(K, N, scale=0.05)
        sf = torch.tensor(0.2, device=dev)
        errs = {}
        for qx in (True, False):
            before = term_matmul.kernel_launches["mma"]
            out = term_matmul(x, w, sf, 4, 2, quantize_x=qx)
            ref = term_matmul_ref(x, w, sf, 4, 2, quantize_x=qx)
            torch.cuda.synchronize()
            if term_matmul.kernel_launches["mma"] != before + 1:
                fail(f"term_matmul {(M, K, N)} did not take the mma kernel")
            scale = float(ref.abs().max())
            errs[qx] = float((out - ref).abs().max())
            if not torch.allclose(out, ref, rtol=1e-5, atol=1e-4 * scale):
                fail(f"term_matmul mma {(M, K, N)} quantize_x={qx}: max "
                     f"|diff| {errs[qx]} (max |ref| {scale})")
        xq = tr_quantize_ref(x, sf, 4, 1, 2)  # the library call's input
        nbytes = 4 * (M * K + K * N + M * N)
        flops = 2 * M * K * N
        b, by = bound_ms(nbytes, 3 * flops, PEAK_OPS_PER_S["tf32"])  # 3xTF32
        t = timings(torch, lambda: launch(x, w, sf, 4, 2),
                    lambda: term_matmul_ref(x, w, sf, 4, 2),
                    lambda: torch.matmul(xq, w))
        raw_ms = device_ms(torch, lambda: launch(x, w, sf, 4, 2,
                                                 quantize_x=False))
        p = tm_mod.plan(M, N, K, "f32", "f32",
                        tm_mod._sm_count(dev.index or 0), None,
                        tm_mod._mma_clusters(dev.index or 0))
        per_shape[f"{M}x{K}x{N}"] = dict(
            splits=p.splits, k_per_split=p.k_per_split,
            max_abs_err=errs[True], raw_max_abs_err=errs[False], **t,
            raw_ms=raw_ms, reveal_share=(t["ms"] - raw_ms) / t["ms"],
            bound_ms=b, bound_by=by,
            bound_fp32_ms=bound_ms(nbytes, flops)[0])
    # x whose data starts one float past a 16-byte boundary: 4-byte loads.
    x = randn(128 * 784 + 1).relu()[1:].view(128, 784)
    w = randn(784, 512, scale=0.05)
    sf = torch.tensor(0.2, device=dev)
    ref = term_matmul_ref(x, w, sf, 4, 2)
    out = term_matmul(x, w, sf, 4, 2)
    torch.cuda.synchronize()
    if not torch.allclose(out, ref, rtol=1e-5,
                          atol=1e-4 * float(ref.abs().max())):
        fail("term_matmul mma with unaligned x: max |diff| "
             f"{float((out - ref).abs().max())}")
    head = per_shape["128x784x512"]
    results["term_matmul_kernel_mma"] = dict(
        shape=[128, 784, 512], per_shape=per_shape,
        clusters_at_once=list(tm_mod._mma_clusters(dev.index or 0)),
        max_abs_err=max(max(v["max_abs_err"], v["raw_max_abs_err"])
                        for v in per_shape.values()),
        **{k: head[k] for k in ("ms", "eager_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "bound_fp32_ms",
                                "raw_ms", "reveal_share")})
    emit({"phase": "kernels", "ok": True, "results": results})
    return results


# ---------------------------------------------------------------- phase 3


def phase_main_path(torch):
    from tq_tpu_torch.data import load_mnist
    from tq_tpu_torch.evals.mlp import run_sweep

    _reset_counts()
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
    launches = _read_counts()
    for name, exp in EXPECTED_SWEEPS.items():
        for key in ("accs", "tmacs", "param_bits"):
            if got[name][key] != [float(v) for v in exp[key]]:
                fail(f"{name} {key}: {got[name][key]} != JAX {exp[key]}")
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_grouped",
                                 "term_matmul_kernel_mma", "histogram"],
                      "main")
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


# ---------------------------------------------------------------- phase 5


def _tm_weights(torch, fmt: str, K: int, N: int, gen, dev):
    """(weight in format ``fmt``, w_sf or None, the float32 values the
    kernel multiplies: q for integer and packed weights, w otherwise)."""
    from tq_tpu_torch.kernels.term_matmul import (pack_weight_u8s,
                                                  unpack_weight_u8s)

    w_sf = torch.tensor(0.0123, device=dev)
    if fmt in ("f32", "bf16"):
        w = torch.randn(K, N, generator=gen, device=dev) * 0.05
        if fmt == "bf16":
            w = w.to(torch.bfloat16)
        return w, None, w.to(torch.float32)
    if fmt in ("int8", "int16"):
        # int16 past bf16's 8 significant bits and TF32's 11
        hi = 127 if fmt == "int8" else 20000
        q = torch.randint(-hi, hi + 1, (K, N), generator=gen, device=dev)
        return q.to(getattr(torch, fmt)), w_sf, q.to(torch.float32)
    # The 9-bit pack over the full magnitude range 0..255 and both signs.
    q = torch.randint(-255, 256, (K, N), generator=gen, device=dev)
    q[0, :3] = torch.tensor([0, 255, -255], device=dev)[:N]
    wq = q.to(torch.float32) * w_sf
    wp = pack_weight_u8s(wq, w_sf, 8)
    if not torch.equal(unpack_weight_u8s(wp, k=K), wq):
        fail(f"9-bit pack ({K}, {N}) does not round-trip on the card")
    return wp, None, q.to(torch.float32)


def _weight_bytes(fmt: str, K: int, N: int) -> int:
    if fmt == "packed8":
        K8 = -(-K // 8) * 8
        return K8 * N + K8 // 8 * N
    return {"f32": 4, "bf16": 2, "int16": 2, "int8": 1}[fmt] * K * N


# Together past the 50 MB L2 cache: the cold timings rotate over copies
# of the weights adding up to at least this many bytes.
COLD_BYTES = 150e6
# M of the crossover table, timed on both kernels.
CROSSOVER_M = (1, 2, 4, 8, 16)


def _copy_weight(w):
    from tq_tpu_torch.kernels.term_matmul import PackedWeight8

    if isinstance(w, PackedWeight8):
        return PackedWeight8(w.lo.clone(), w.signs.clone(), w.w_sf)
    return w.clone()


def _offset_weight(torch, w):
    """``w`` as a contiguous view whose data starts one element past a
    16-byte boundary (every row of every format then starts unaligned)."""
    from tq_tpu_torch.kernels.term_matmul import PackedWeight8

    def shift(t):
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    if isinstance(w, PackedWeight8):
        return PackedWeight8(shift(w.lo), shift(w.signs), w.w_sf)
    return shift(w)


def _serving_row_times(torch, variant: str, weight, x) -> dict:
    """A ``term_matmul`` serving row at x's shape: device ms warm (the same
    weights every call) and cold (copies past the L2), eager ms, the plain
    version's and ``torch.matmul``'s ms on the same operands (the
    already-quantized input and the integer weights, or the raw input and
    the decoded float32 weights) and the bound.  ``weight``:
    ``_tm_weights``' triple."""
    from tq_tpu_torch.kernels.term_matmul import (VARIANTS, launch,
                                                  term_matmul_ref)
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_int_ref

    mode, fmt, quantize_x = VARIANTS[variant]
    w, w_sf, wv = weight
    (M, K), N = x.shape, wv.shape[1]
    sf = torch.tensor(0.03, device=x.device)
    bits, terms = (7, 3) if mode == "int8" else (8, 3)
    kw = dict(bf16=mode == "bf16", int8=mode == "int8", w_sf=w_sf,
              quantize_x=quantize_x)

    def call(wc):
        return lambda: launch(x, wc, sf, bits, terms, **kw)

    if quantize_x:
        xa = tr_quantize_int_ref(x, sf, bits, terms).to(torch.float32)
        wa = wv
    else:
        xa = x
        wa = wv * (w.w_sf if fmt == "packed8" else w_sf)
    wbytes = _weight_bytes(fmt, K, N)
    b, by = bound_ms(4 * M * K + wbytes + 4 * M * N, 2 * M * K * N,
                     PEAK_OPS[mode])
    copies = [w] + [_copy_weight(w) for _ in range(
        max(1, int(-(-COLD_BYTES // wbytes)) - 1))]
    out = dict(**timings(torch, call(w),
                         lambda: term_matmul_ref(x, w, sf, bits, terms, **kw),
                         lambda: torch.matmul(xa, wa)),
               cold_ms=device_ms(torch, [call(c) for c in copies]),
               cold_copies=len(copies), bound_ms=b, bound_by=by)
    out["bound_share_cold"] = b / out["cold_ms"]
    return out


# The f32 mode's narrow weight formats at M > STREAM_MAX_M, on the mma
# kernel: the batch-64 serving step's decoder (phase lstm_batch_serving)
# and the MLP's first layer.
NARROW_CELLS = [(64, 650, VOCAB), (128, 784, 512)]
NARROW_VARIANTS = ("f32_bf16", "f32_int8", "f32_int16", "f32_packed8",
                   "f32_raw_bf16", "f32_raw_int8", "f32_raw_int16",
                   "f32_raw_packed8")


def _narrow_f32_cells(torch, weights: dict, gen, smi: str) -> dict:
    """Each narrow f32 variant at NARROW_CELLS on the mma kernel (the
    route): against the plain version, and where its plan is float32
    weights' (the same tile and K split) bit for bit against the mma
    kernel on the same weights widened to float32, its output times w_sf;
    timed beside ``torch.matmul`` on the decoded float32 weights (TF32
    off) and the bound (bytes as stored; two TF32 products a
    multiply-add, three for int16)."""
    from tq_tpu_torch.kernels import term_matmul as tm_mod
    from tq_tpu_torch.kernels.term_matmul import (VARIANTS, launch,
                                                  term_matmul,
                                                  term_matmul_ref)
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_ref

    dev = torch.device("cuda")
    sms = tm_mod._sm_count(dev.index or 0)
    cells = {}
    for M, K, N in NARROW_CELLS:
        x = torch.randn(M, K, generator=gen, device=dev)
        sf = torch.tensor(0.03, device=dev)
        for variant in NARROW_VARIANTS:
            _, fmt, quantize_x = VARIANTS[variant]
            key = (fmt, K, N)
            if key not in weights:
                weights[key] = _tm_weights(torch, fmt, K, N, gen, dev)
            w, w_sf, wv = weights[key]
            scale = w.w_sf if fmt == "packed8" else w_sf  # None for bf16
            kw = dict(w_sf=w_sf, quantize_x=quantize_x)
            before = term_matmul.kernel_launches["mma"]
            out = term_matmul(x, w, sf, 8, 3, **kw)
            torch.cuda.synchronize()
            if term_matmul.kernel_launches["mma"] != before + 1:
                fail(f"term_matmul {variant} {(M, K, N)} did not take the "
                     "mma kernel")
            ref = term_matmul_ref(x, w, sf, 8, 3, **kw)
            torch.cuda.synchronize()
            if not torch.allclose(out, ref, rtol=1e-5,
                                  atol=1e-4 * float(ref.abs().max())):
                fail(f"term_matmul mma {variant} {(M, K, N)}: max |diff| "
                     f"{float((out - ref).abs().max())}")
            plans = [tm_mod.plan(M, N, K, f, "f32", sms, "mma",
                                 tm_mod._mma_clusters(dev.index or 0,
                                                      "mma", "f32", f))
                     for f in (fmt, "f32")]
            same_plan = plans[0] == plans[1]
            if same_plan:
                wide = launch(x, wv, sf, 8, 3, quantize_x=quantize_x,
                              kernel="mma")
                if scale is not None:
                    wide = wide * scale
                torch.cuda.synchronize()
                if not torch.equal(out, wide):
                    fail(f"term_matmul mma {variant} {(M, K, N)}: not bit "
                         "for bit with float32 weights times w_sf (max "
                         f"|diff| {float((out - wide).abs().max())})")
            xa = tr_quantize_ref(x, sf, 8, 1, 3) if quantize_x else x
            wa = wv * scale if scale is not None else wv
            products = 3 if fmt == "int16" else 2
            b, by = bound_ms(4 * M * K + _weight_bytes(fmt, K, N) + 4 * M * N,
                             products * 2 * M * K * N, PEAK_OPS_PER_S["tf32"])
            t = timings(torch, lambda: launch(x, w, sf, 8, 3, **kw),
                        lambda: term_matmul_ref(x, w, sf, 8, 3, **kw),
                        lambda: torch.matmul(xa, wa))
            cells[f"{variant} {M}x{K}x{N}"] = dict(
                max_abs_err=float((out - ref).abs().max()),
                bit_equal_float32_weights=same_plan or None,
                splits=plans[0].splits, k_per_split=plans[0].k_per_split,
                products=products, **t, bound_ms=b, bound_by=by, card=smi)
            del out, ref, xa, wa
        torch.cuda.empty_cache()
    return cells


# The mma_lp kernel's timed cells: (M, K, N, variants); the kernels line
# heads its row with MMA_LP_HEAD.
MMA_LP_CELLS = [
    (128, 784, 512, ("bf16", "bf16_int16", "bf16_packed8", "int8_int8")),
    (350, 650, 2600, ("bf16", "bf16_int16", "bf16_packed8", "int8_int8")),
    (8192, 2048, 512, ("bf16", "bf16_raw", "int8_int8")),
]
MMA_LP_HEAD = "int8_int8 350x650x2600"


def phase_term_matmul_modes(torch, smi: str):
    from tq_tpu_torch.kernels.term_matmul import (STREAM_MAX_M, VARIANTS,
                                                  launch, term_matmul,
                                                  term_matmul_ref)
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_int_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    T = STREAM_MAX_M
    # Ragged shapes (M, N off the 64-tile, K off a multiple of 8) and the
    # LSTM serving shapes: the recurrent (1, 650, 2600) and the decoder
    # (1, 650, 33278) at one token, and a 350-row chunk; then small M on
    # the weight-streaming kernel: N = 2 mod 16 (rows start at every even
    # byte offset), K off a multiple of 8, M in {1, 2, T}.
    shapes = [(3, 37, 19), (77, 300, 45), (1, 650, 2600), (350, 650, 2600),
              (1, 650, VOCAB), (1, 19, 34), (2, 19, 34), (T, 19, 34),
              (2, 650, VOCAB), (T, 650, VOCAB), (T + 1, 650, 2600)]
    weights = {}
    cases, max_err = 0, {}
    kernel_before = dict(term_matmul.kernel_launches)
    want_stream = want_mma = want_mma_lp = 0
    mma_lp_err = 0.0
    for variant, (mode, fmt, quantize_x) in VARIANTS.items():
        bits, terms = (7, 3) if mode == "int8" else (8, 3)
        for M, K, N, offset in [(*sh, False) for sh in shapes] + [
                (1, 19, 34, True), (1, 650, VOCAB, True)]:
            key = (fmt, K, N)
            if key not in weights:
                weights[key] = _tm_weights(torch, fmt, K, N, gen, dev)
            w, w_sf, _ = weights[key]
            if offset:  # data not 16-byte aligned
                w = _offset_weight(torch, w)
            x = torch.randn(M, K, generator=gen, device=dev)
            sf = torch.tensor(0.03, device=dev)
            kw = dict(bf16=mode == "bf16", int8=mode == "int8", w_sf=w_sf,
                      quantize_x=quantize_x)
            out = term_matmul(x, w, sf, bits, terms, **kw)
            ref = term_matmul_ref(x, w, sf, bits, terms, **kw)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if mode == "int8":
                if not torch.equal(out, ref):
                    fail(f"term_matmul {variant} {(M, K, N)}: not bit-exact "
                         f"(max |diff| {err})")
            elif not torch.allclose(out, ref, rtol=1e-5, atol=1e-4 * scale):
                fail(f"term_matmul {variant} {(M, K, N)}: max |diff| {err} "
                     f"(max |ref| {scale})")
            max_err[variant] = max(max_err.get(variant, 0.0), err)
            cases += 1
            want_stream += M <= T
            want_mma += M > T and mode == "f32"
            want_mma_lp += M > T and mode != "f32"
            if M > T and mode != "f32":
                mma_lp_err = max(mma_lp_err, err)
    # The mma_lp kernel's other reveal paths: the kept value computed
    # above its table's 8 bits (bf16 at 12 bits), and +128 saturated at
    # 127 (int8, 7 bits, one term).
    for variant in VARIANTS:
        mode, fmt, quantize_x = VARIANTS[variant]
        if mode == "f32" or not quantize_x:
            continue
        bits, terms = (7, 1) if mode == "int8" else (12, 5)
        w, w_sf, _ = weights[(fmt, 300, 45)]
        x = torch.randn(77, 300, generator=gen, device=dev)
        sf = torch.tensor(0.03 if mode == "int8" else 0.001, device=dev)
        kw = dict(bf16=mode == "bf16", int8=mode == "int8", w_sf=w_sf)
        out = term_matmul(x, w, sf, bits, terms, **kw)
        ref = term_matmul_ref(x, w, sf, bits, terms, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if mode == "int8" and not torch.equal(out, ref):
            fail(f"term_matmul {variant} bits 7, 1 term: not bit-exact")
        if not torch.allclose(out, ref, rtol=1e-5,
                              atol=1e-4 * float(ref.abs().max())):
            fail(f"term_matmul {variant} bits {bits}: max |diff| {err}")
        max_err[variant] = max(max_err[variant], err)
        mma_lp_err = max(mma_lp_err, err)
        cases += 1
        want_mma_lp += 1
    by_kernel = {k: term_matmul.kernel_launches[k] - kernel_before[k]
                 for k in kernel_before}
    if by_kernel["stream"] != want_stream:
        fail(f"term_matmul: {by_kernel['stream']} launches of the "
             f"streaming kernel for {want_stream} cases with M <= {T}")
    if by_kernel["mma"] != want_mma:
        fail(f"term_matmul: {by_kernel['mma']} launches of the mma kernel "
             f"for {want_mma} f32 cases with M > {T}")
    if by_kernel["mma_lp"] != want_mma_lp:
        fail(f"term_matmul: {by_kernel['mma_lp']} launches of the mma_lp "
             f"kernel for {want_mma_lp} bf16 and int8 cases with M > {T}")

    def call(w, x, sf, bits, terms, kw, kernel=None):
        return lambda: launch(x, w, sf, bits, terms, kernel=kernel, **kw)

    # Time the rows of the serving path at their M = 1 shapes: warm (the
    # same weights every call) and cold (copies past the L2), beside the
    # bound, the plain version and torch.matmul.
    results = {}
    for row, variant in TERM_MATMUL_ROWS.items():
        mode, fmt, _ = VARIANTS[variant]
        row_shapes = [(1, 650, VOCAB)]
        if fmt == "packed8" and mode == "f32":
            row_shapes.append((1, 650, 2600))  # the packed recurrent weights
        per_shape = {f"{M}x{K}x{N}": _serving_row_times(
            torch, variant, weights[(VARIANTS[variant][1], K, N)],
            torch.randn(M, K, generator=gen, device=dev))
            for M, K, N in row_shapes}
        head = per_shape[f"1x650x{VOCAB}"]
        results[row] = dict(shape=[1, 650, VOCAB], variant=variant,
                            per_shape=per_shape, max_abs_err=max_err[variant],
                            **{k: head[k] for k in (
                                "ms", "cold_ms", "eager_ms",
                                "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "bound_share_cold")})

    # The crossover: the streaming kernel and the kernels above it (warm)
    # at M in CROSSOVER_M on the decoder and recurrent widths, for the six
    # decoder variants; "faster up to" compares it with the one the route
    # takes above STREAM_MAX_M (mma in the f32 mode, mma_lp in the bf16 and
    # int8 modes).
    crossover, faster_up_to = {}, {}
    for N in (VOCAB, 2600):
        K = 650
        up_to = max(CROSSOVER_M)
        for row, variant in TERM_MATMUL_ROWS.items():
            mode, fmt, quantize_x = VARIANTS[variant]
            w, w_sf, _ = weights[(fmt, K, N)]
            bits, terms = (7, 3) if mode == "int8" else (8, 3)
            kw = dict(bf16=mode == "bf16", int8=mode == "int8", w_sf=w_sf,
                      quantize_x=quantize_x)
            sf = torch.tensor(0.03, device=dev)
            above = "mma" if mode == "f32" else "mma_lp"
            table = {}
            for M in CROSSOVER_M:
                x = torch.randn(M, K, generator=gen, device=dev)
                table[M] = {k: device_ms(torch, call(w, x, sf, bits, terms,
                                                    kw, k))
                            for k in ("stream", above)}
            crossover.setdefault(f"{K}x{N}", {})[variant] = table
            faster = 0  # the largest M up to which the stream kernel wins
            for M in CROSSOVER_M:
                if table[M]["stream"] >= table[M][above]:
                    break
                faster = M
            up_to = min(up_to, faster)
        faster_up_to[f"{K}x{N}"] = up_to
    narrow = _narrow_f32_cells(torch, weights, gen, smi)
    # The bf16 and int8 modes at M > STREAM_MAX_M, which no path runs, on
    # the mma_lp kernel (the route), beside the bound, the plain version
    # and the library call on the
    # already-quantized input (bf16 torch.matmul; torch._int_mm on
    # operands zero-padded to its multiples of 8): the MLP and LSTM-chunk
    # eval shapes, and bench.py::bench_matmul's (8192, 2048, 512).
    mma_lp = {}
    for M, K, N, variants in MMA_LP_CELLS:
        for variant in variants:
            mode, fmt, quantize_x = VARIANTS[variant]
            w, w_sf, wv = weights.get((fmt, K, N)) or _tm_weights(
                torch, fmt, K, N, gen, dev)
            x = torch.randn(M, K, generator=gen, device=dev)
            sf = torch.tensor(0.03, device=dev)
            bits, terms = (7, 3) if mode == "int8" else (8, 3)
            kw = dict(bf16=mode == "bf16", int8=mode == "int8", w_sf=w_sf,
                      quantize_x=quantize_x)
            before = term_matmul.kernel_launches["mma_lp"]
            out = term_matmul(x, w, sf, bits, terms, **kw)
            ref = term_matmul_ref(x, w, sf, bits, terms, **kw)
            torch.cuda.synchronize()
            if term_matmul.kernel_launches["mma_lp"] != before + 1:
                fail(f"term_matmul {variant} {(M, K, N)} did not take the "
                     "mma_lp kernel")
            if mode == "int8" and not torch.equal(out, ref):
                fail(f"term_matmul mma_lp {variant} {(M, K, N)}: not "
                     f"bit-exact")
            if not torch.allclose(out, ref, rtol=1e-5,
                                  atol=1e-4 * float(ref.abs().max())):
                fail(f"term_matmul mma_lp {variant} {(M, K, N)}: max "
                     f"|diff| {float((out - ref).abs().max())}")
            xq = tr_quantize_int_ref(x, sf, bits, terms)
            if mode == "int8":
                pk = -K % 8
                a = torch.nn.functional.pad(xq.clamp(max=127).to(torch.int8),
                                            (0, pk))
                b = torch.nn.functional.pad(wv.to(torch.int8), (0, 0, 0, pk))
                b = b.t().contiguous().t()  # column-major, as cuBLASLt takes

                def library(a=a, b=b):
                    return torch._int_mm(a, b)
            else:
                a, b = xq.to(torch.bfloat16), wv.to(torch.bfloat16)

                def library(a=a, b=b):
                    return torch.matmul(a, b)
            bnd, by = bound_ms(4 * M * K + _weight_bytes(fmt, K, N)
                               + 4 * M * N, 2 * M * K * N, PEAK_OPS[mode])
            t = timings(torch, lambda: launch(x, w, sf, bits, terms, **kw),
                        lambda: term_matmul_ref(x, w, sf, bits, terms,
                                                **kw), library)
            mma_lp[f"{variant} {M}x{K}x{N}"] = dict(
                max_abs_err=float((out - ref).abs().max()),
                **t, bound_ms=bnd, bound_by=by, card=smi)
            mma_lp_err = max(mma_lp_err, mma_lp[f"{variant} {M}x{K}x{N}"][
                "max_abs_err"])
            del x, out, ref, xq, a, b, library
    torch.cuda.empty_cache()  # bench.py's shape: x alone is 67 MB
    emit({"phase": "term_matmul_modes", "ok": True, "cases": cases,
          "variants": len(VARIANTS), "stream_max_m": T,
          "launches_by_kernel": by_kernel, "max_abs_err": max_err,
          "results": results, "crossover_ms": crossover,
          "stream_faster_up_to_m": faster_up_to,
          "narrow_f32_ms": narrow, "mma_lp_ms": mma_lp, "card": smi})
    head = mma_lp[MMA_LP_HEAD]
    big = {v: mma_lp[f"{v} 8192x2048x512"]["ms"] for v in ("bf16",
                                                            "bf16_raw")}
    results["term_matmul_kernel_mma_lp"] = dict(
        shape=[350, 650, 2600], variant="int8_int8", modes_m_gt_8=mma_lp,
        max_abs_err=mma_lp_err, raw_ms=big["bf16_raw"],
        reveal_share=(big["bf16"] - big["bf16_raw"]) / big["bf16"],
        **{k: head[k] for k in ("ms", "eager_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by")})
    results["narrow_f32"] = narrow  # main attaches it to the mma row
    return results


# ---------------------------------------------------------------- phase 6


def _reset_counts():
    from tq_tpu_torch.kernels.histogram import histogram
    from tq_tpu_torch.kernels.term_matmul import term_matmul
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize, tr_scale_copy

    for counts in (tr_quantize.launches, term_matmul.launches,
                   term_matmul.kernel_launches, tr_scale_copy.launches,
                   histogram.launches):
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict:
    """Launches per kernel row since the last reset."""
    from tq_tpu_torch.kernels.histogram import histogram
    from tq_tpu_torch.kernels.term_matmul import term_matmul
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize, tr_scale_copy

    out = {f"tr_quantize_{k}": n for k, n in tr_quantize.launches.items()}
    out["tr_scale_copy"] = tr_scale_copy.launches["scale_copy"]
    out["histogram"] = histogram.launches["histogram"]
    for row, variant in TERM_MATMUL_ROWS.items():
        out[row] = term_matmul.launches[variant]
    out["term_matmul_other"] = sum(
        n for k, n in term_matmul.launches.items()
        if k not in TERM_MATMUL_ROWS.values())
    for kernel, n in term_matmul.kernel_launches.items():
        out[f"term_matmul_kernel_{kernel}"] = n
    return out


def _require_launched(launches: dict, rows, path: str) -> None:
    for name in rows:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")


def phase_lstm_sweep(torch, ckpt: Path):
    from tq_tpu_torch.data.wikitext import load_corpus
    from tq_tpu_torch.evals.lstm import run_sweep

    if load_corpus()[1] != "synthetic":
        fail("EXPECTED_LSTM_SWEEPS hold the synthetic test stream's numbers; "
             "unset TQ_DATA_DIR")
    _reset_counts()
    t0 = time.perf_counter()
    got, sweep_seconds = {}, {}
    for name, exp in EXPECTED_LSTM_SWEEPS.items():
        s = exp["settings"]
        t1 = time.perf_counter()
        got[name] = run_sweep(s["wb"], s["wt"], s["db"], s["dt"], s["gs"],
                              checkpoint=str(ckpt), verbose=False,
                              device="cuda")
        torch.cuda.synchronize()
        sweep_seconds[name] = time.perf_counter() - t1
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    gap = 0.0
    for name, exp in EXPECTED_LSTM_SWEEPS.items():
        for key in ("tmacs", "param_bits"):
            if got[name][key] != [float(v) for v in exp[key]]:
                fail(f"{name} {key}: {got[name][key]} != JAX {exp[key]}")
        for a, b in zip(got[name]["ppls"], exp["ppls"]):
            gap = max(gap, abs(a - b) / abs(b))
    if gap > 1e-3:
        fail(f"LSTM sweep ppl differs from the JAX package's by {gap} "
             "(relative)")
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_grouped", "histogram"],
                      "LSTM sweep")
    emit({"phase": "lstm_sweep", "ok": True, "seconds": seconds,
          "sweep_seconds": sweep_seconds,
          "settings": sum(len(e["ppls"]) for e in
                          EXPECTED_LSTM_SWEEPS.values()),
          "ppl_max_rel_gap": gap, "launches": launches, "results": got})
    return launches


# ---------------------------------------------------------------- phase 7


def _lstm_inputs(ckpt: Path):
    from tq_tpu_torch.data.wikitext import batchify, load_corpus
    from tq_tpu_torch.evals.lstm import EVAL_BATCH
    from tq_tpu_torch.utils.checkpoint import load_params

    corpus, _ = load_corpus()
    return load_params(ckpt), batchify(np.asarray(corpus.test), EVAL_BATCH)


def phase_generation(torch, ckpt: Path):
    from tq_tpu_torch.evals.generate import (generate_tr, sample_quantized,
                                             serving_model)
    from tq_tpu_torch.utils.params import params_from_jax

    params_np, stream = _lstm_inputs(ckpt)
    params = params_from_jax(params_np, "cuda")
    _reset_counts()
    graphs0 = _graph_counts_now()
    t0 = time.perf_counter()
    tokens, seconds = {}, {}
    for name, tr, pack, fixed in GEN_CONFIGS:
        t1 = time.perf_counter()
        if fixed:  # no entry point serves the fixed decoder: its pieces
            qp, qc, qs = serving_model(params, tr, pack, stream,
                                       quantize_decoder_input=True)
            toks = sample_quantized(qp, qc, qs, VOCAB, GEN_WORDS,
                                    seed=GEN_SEED)
        else:
            toks = generate_tr(params, VOCAB, GEN_WORDS, seed=GEN_SEED,
                               tr=tr, pack_fmt=pack, calib_stream=stream,
                               device="cuda")
        seconds[name] = time.perf_counter() - t1
        if len(toks) != GEN_WORDS or not all(0 <= t < VOCAB for t in toks):
            fail(f"generation {name}: tokens out of range or missing")
        tokens[name] = toks
    total = time.perf_counter() - t0
    launches = _read_counts()
    _require_launched(launches, [
        "tr_quantize_elementwise", "tr_quantize_grouped", "histogram",
        "term_matmul_raw_packed8", "term_matmul_raw_int16",
        "term_matmul_raw_int8", "term_matmul_bf16_int16",
        "term_matmul_bf16_packed8", "term_matmul_int8",
        "term_matmul_kernel_stream"], "generation")
    emit({"phase": "generation", "ok": True, "seconds": total,
          "config_seconds": seconds, "words": GEN_WORDS,
          "launches": launches, "step_graphs": _graph_counts(graphs0),
          "first_tokens": {k: v[:8] for k, v in tokens.items()}})
    return launches, tokens


# ---------------------------------------------------------------- phase 8


def _teacher_forced(torch, qp, qc, qs, tokens, device):
    """Per token, batch 1: the step's raw inputs, quantized inputs, LSTM
    output, new hidden state and log-probs."""
    from tq_tpu_torch.layers.linear import tr_dense_apply
    from tq_tpu_torch.layers.lstm import tr_lstm_apply
    from tq_tpu_torch.layers.quantize import act_quantize
    from tq_tpu_torch.models import lstm_lm

    tr_rnn, tr_dec = qc["rnn"], qc["decoder"]
    H = qp["rnn"][0]["b_hh"].shape[0] // 4
    hidden = lstm_lm.init_hidden(1, nhid=H, nlayers=len(qp["rnn"]),
                                 device=device)
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    rows = []
    for t in tokens:
        tok = torch.tensor([[t]], device=device)
        emb = qp["encoder"]["w"][tok]
        q_in = [act_quantize(p, qs["rnn"]["sf"], tr_rnn.data_bits,
                             tr_rnn.data_terms) for p in (emb, *hidden)]
        out, new_hidden, _ = tr_lstm_apply(qp["rnn"], tr_rnn, qs["rnn"], emb,
                                           hidden, False)
        dec_in = out.reshape(1, H)
        if tr_dec.quantize_input:
            q_in.append(act_quantize(dec_in, qs["decoder"]["sf"],
                                     tr_dec.data_bits, tr_dec.data_terms))
        logits, _ = tr_dense_apply(qp["decoder"], tr_dec, qs["decoder"],
                                   dec_in, False)
        logp = torch.log_softmax(logits, dim=-1)
        if not torch.equal(logp, fwd(qp, qs, tok, hidden)[0]):
            fail("teacher-forced step differs from the model's forward")
        rows.append(dict(emb=emb, hidden=hidden, q_in=q_in, out=out,
                         new_hidden=new_hidden, logp=logp))
        hidden = new_hidden
    return rows


def _packs_equal(a, b) -> bool:
    from tq_tpu_torch.utils.checkpoint import flatten_tree

    fa, fb = flatten_tree({"d": a["decoder"], "r": a["rnn"]}), \
        flatten_tree({"d": b["decoder"], "r": b["rnn"]})
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


def phase_serving_compare(torch, ckpt: Path, tokens: dict, card: str,
                          smi: str):
    """The serving models on the card and on the CPU, from the same
    converted weights: scales, packs and teacher-forced log-probs; and the
    sampler's tokens/s on the card."""
    from tq_tpu_torch.evals.generate import calibrate, sample_quantized
    from tq_tpu_torch.layers.linear import tr_dense_apply
    from tq_tpu_torch.layers.lstm import tr_lstm_apply
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.utils.params import params_from_jax

    params_np, stream = _lstm_inputs(ckpt)
    params = params_from_jax(params_np, "cuda")
    results = {}
    groups: dict = {}
    for name, tr, pack, fixed in GEN_CONFIGS:
        groups.setdefault((tr, fixed), []).append((name, pack))
    for (tr, fixed), packs in groups.items():
        wb, gs, wt, db, dt = tr
        qp, qc, qs0 = lstm_lm.convert(params, wb, gs, wt, db, dt,
                                      quantize_decoder_input=fixed)
        qs = calibrate(qp, qc, qs0, stream)
        # The CPU path starts from the card's converted weights (the
        # conversion kernels are bit-exact: phase 2).
        qp_c = params_from_jax(qp, "cpu")
        qs_c = calibrate(qp_c, qc, params_from_jax(qs0, "cpu"), stream)
        sfs = {}
        for q in ("rnn", "decoder"):
            a, b = float(qs[q]["sf"]), float(qs_c[q]["sf"])
            if a != b:
                fail(f"serving {tr}: calibrated {q} sf {a} (card) != {b} "
                     "(cpu)")
            sfs[q] = a
        for name, pack in packs:
            qpk = lstm_lm.pack(qp, qc, fmt=pack)
            qpk_c = lstm_lm.pack(qp_c, qc, fmt=pack)
            if not _packs_equal(qpk, qpk_c):
                fail(f"serving {name}: packed weights differ card vs cpu")
            sample_quantized(qpk, qc, qs, VOCAB, 5, seed=GEN_SEED)  # warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sample_quantized(qpk, qc, qs, VOCAB, GEN_WORDS, seed=GEN_SEED)
            tok_s = GEN_WORDS / (time.perf_counter() - t0)
            toks = tokens[name][:TEACHER_TOKENS]
            rows_g = _teacher_forced(torch, qpk, qc, qs, toks, "cuda")
            rows_c = _teacher_forced(torch, qpk_c, qc, qs_c, toks, "cpu")
            flipped, rnn_err, dec_err, logp_err = 0, 0.0, 0.0, 0.0
            for g, c in zip(rows_g, rows_c):
                # Layer by layer on the CPU's inputs.
                out, hid, _ = tr_lstm_apply(
                    qpk["rnn"], qc["rnn"], qs["rnn"], c["emb"].cuda(),
                    tuple(h.cuda() for h in c["hidden"]), False)
                rnn_err = max([rnn_err, float((out.cpu() - c["out"]).abs()
                                              .max())]
                              + [float((a.cpu() - b).abs().max())
                                 for a, b in zip(hid, c["new_hidden"])])
                logits, _ = tr_dense_apply(
                    qpk["decoder"], qc["decoder"], qs["decoder"],
                    c["out"].reshape(1, -1).cuda(), False)
                dec_err = max(dec_err, float(
                    (torch.log_softmax(logits, -1).cpu() - c["logp"]).abs()
                    .max()))
                if any(not torch.equal(a.cpu(), b)
                       for a, b in zip(g["q_in"], c["q_in"])):
                    flipped += 1
                else:
                    logp_err = max(logp_err, float(
                        (g["logp"].cpu() - c["logp"]).abs().max()))
            for what, err in (("LSTM", rnn_err), ("decoder", dec_err),
                              ("log-probs", logp_err)):
                if err > 1e-4:
                    fail(f"serving {name}: {what} differs by {err} card vs "
                         "cpu")
            results[name] = dict(tr=list(tr), pack=pack, fixed_decoder=fixed,
                                 sf=sfs, tokens_per_s=tok_s,
                                 rows_with_boundary_flip=flipped,
                                 lstm_max_abs_err=rnn_err,
                                 decoder_max_abs_err=dec_err,
                                 logp_max_abs_err=logp_err)
    emit({"phase": "serving_compare", "ok": True, "card": card,
          "nvidia_smi": smi, "teacher_tokens": TEACHER_TOKENS,
          "results": results})


# ---------------------------------------------------------------- phase 9


# The batch serving sampler (bench.py::bench_generate's run_b at BATCH =
# 64; examples/lm_serving.py serves at batch >= 8) on the model
# bench.py serves, converted at (8, 8, 24, 8, 8) with the decoder on raw
# input: (name, pack, the dtype of the layers conversion leaves float32,
# {variant: launches a step}).  Layer 0's input and recurrent products and
# the decoder take the narrow format; layer 1 stays float32
# (torch.matmul), or is bf16-stored and streams through the kernel too.
BATCH = 64
BATCH_SERVING = [
    ("u8s", "u8s", None, {"f32_raw_packed8": 3}),
    ("int16-bf16", "int", "bfloat16", {"f32_raw_int16": 3,
                                       "f32_raw_bf16": 2}),
]


def _row_flips(torch, qp, qs, tr, tok, hidden_a, hidden_b):
    """Per batch row: whether the shared activation quantizer's codes of
    the step's inputs (the embedding, h and c of both layers) differ
    between two hidden states on two devices."""
    from tq_tpu_torch.layers.quantize import act_quantize

    emb = qp["encoder"]["w"][tok.long()]
    flips = torch.zeros(tok.shape[1], dtype=torch.bool)
    for a, b in zip((emb, *hidden_a), (emb, *hidden_b)):
        qa = act_quantize(a, qs["rnn"]["sf"], tr.data_bits, tr.data_terms)
        qb = act_quantize(b.to(a.device), qs["rnn"]["sf"], tr.data_bits,
                          tr.data_terms)
        flips |= (qa != qb).any(dim=-1).any(dim=0).cpu()
    return flips


def phase_lstm_batch_serving(torch, ckpt: Path, smi: str):
    """Greedy sampling at batch 64 for GEN_WORDS steps from the LSTM LM at
    full width, packed as bench.py::bench_generate packs it (u8s, the
    recurrent weights packed too), written here from the port's
    ``lstm_lm.make_quantized_apply``; then with int16 weights and the
    unquantized layer bf16-stored.  Every product runs at M = 64, above
    STREAM_MAX_M: the f32 mode's narrow variants on the mma kernel.
    Held: the launches per variant and per kernel;
    over TEACHER_TOKENS sampled steps, the card's step on the CPU's inputs
    against the CPU plain path on the same packed model (log-probs and
    hidden state within 1e-4), and the card's free-running log-probs
    against the CPU's on every row whose quantized inputs never differed
    (boundary flips counted).  Reported: tokens/s and host ms a step (the
    median of the counted run and two more), and
    the device's ms a step and the decoder's by CUDA-graph replay."""
    from tq_tpu_torch.evals.generate import calibrate
    from tq_tpu_torch.kernels.term_matmul import term_matmul
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.layers.linear import tr_dense_apply
    from tq_tpu_torch.utils.params import params_from_jax

    params_np, stream = _lstm_inputs(ckpt)
    params = params_from_jax(params_np, "cuda")
    qp, qc, qs0 = lstm_lm.convert(params, 8, 8, 24, 8, 8)
    qs = calibrate(qp, qc, qs0, stream)
    qs_c = params_from_jax(qs, "cpu")
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    H = qp["rnn"][0]["w_hh"].shape[0]
    start = torch.as_tensor(np.random.default_rng(GEN_SEED).integers(
        0, VOCAB, (1, BATCH)), device="cuda")
    results, counts = {}, []
    graphs0 = _graph_counts_now()
    for name, pack, half, per_step in BATCH_SERVING:
        qpk = lstm_lm.pack(qp, qc, fmt=pack, rnn=True,
                           rnn_unquantized_dtype=getattr(torch, half)
                           if half else None)

        def sample(steps, qpk=qpk, keep=0):
            """(the tokens fed at each step, (steps + 1, BATCH); the first
            ``keep`` steps' log-probs and hidden inputs)."""
            tok = start
            hidden = lstm_lm.init_hidden(BATCH, nhid=H, device="cuda")
            toks, kept = [tok], []
            for i in range(steps):
                logp, new_hidden, _ = fwd(qpk, qs, tok, hidden)
                if i < keep:
                    kept.append((logp, hidden))
                hidden = new_hidden
                tok = logp.argmax(-1).reshape(1, BATCH)
                toks.append(tok)
            return torch.cat(toks), kept

        with _NoPlainOnCard():
            sample(5)  # warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (toks, kept), launches = _counted(
                torch, lambda: sample(GEN_WORDS, keep=TEACHER_TOKENS))
            seconds = time.perf_counter() - t0
            variants = {k: n for k, n in term_matmul.launches.items() if n}
            counts.append(launches)
            # Host time moves between runs: two more, uncounted.
            runs = [seconds]
            for _ in range(2):
                t0 = time.perf_counter()
                sample(GEN_WORDS)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            seconds = float(np.median(runs))
        if not (0 <= int(toks.min()) and int(toks.max()) < VOCAB):
            fail(f"batch serving {name}: tokens out of range")
        if not all(bool(torch.isfinite(lp).all()) for lp, _ in kept):
            fail(f"batch serving {name}: log-probs not finite")
        want = {v: n * GEN_WORDS for v, n in per_step.items()}
        if variants != want:
            fail(f"batch serving {name}: term_matmul launches by variant "
                 f"{variants}, not {want}")
        mma = launches["term_matmul_kernel_mma"]
        if mma != sum(want.values()) or launches[
                "term_matmul_kernel_stream"] or launches[
                "term_matmul_kernel_mma_lp"]:
            fail(f"batch serving {name}: {mma} mma launches (not "
                 f"{sum(want.values())}), stream "
                 f"{launches['term_matmul_kernel_stream']}, mma_lp "
                 f"{launches['term_matmul_kernel_mma_lp']}")
        _require_launched(launches, ["tr_quantize_elementwise"],
                          f"batch serving {name}")

        # The CPU plain path on the same packed model: the card's step on
        # the CPU's inputs, and the card's free-running steps on the rows
        # whose quantized inputs never differed.
        qpk_c = params_from_jax(qpk, "cpu")
        hidden_c = lstm_lm.init_hidden(BATCH, nhid=H, device="cpu")
        flipped = torch.zeros(BATCH, dtype=torch.bool)
        step_err = hidden_err = free_err = 0.0
        for i, (logp_g, hidden_g) in enumerate(kept):
            tok = toks[i:i + 1]
            flipped |= _row_flips(torch, qpk_c, qs_c, qc["rnn"], tok.cpu(),
                                  hidden_c, hidden_g)
            logp_c, next_c, _ = fwd(qpk_c, qs_c, tok.cpu(), hidden_c)
            logp_s, next_s, _ = fwd(qpk, qs, tok,
                                    tuple(h.cuda() for h in hidden_c))
            step_err = max(step_err, float((logp_s.cpu() - logp_c).abs()
                                           .max()))
            hidden_err = max([hidden_err] + [
                float((a.cpu() - b).abs().max())
                for a, b in zip(next_s, next_c)])
            keep_rows = ~flipped
            if bool(keep_rows.any()):
                free_err = max(free_err, float(
                    (logp_g.cpu()[keep_rows] - logp_c[keep_rows]).abs()
                    .max()))
            hidden_c = next_c
        for what, err in (("log-probs on the CPU's inputs", step_err),
                          ("hidden state on the CPU's inputs", hidden_err),
                          ("free-running log-probs", free_err)):
            if err > 1e-4:
                fail(f"batch serving {name}: {what} differ by {err} card "
                     "vs cpu")

        # Host time a step (above) against the device's: a step's launches
        # captured in a CUDA graph and replayed, no host time between them
        # (no torch.profiler here: after two sessions of it, phase trace's
        # own session missed kernel events); and the decoder's product
        # alone, on the last kept step's output.
        h_last = kept[-1][1][0][-1]
        step_ms = device_ms(torch, lambda: fwd(qpk, qs, toks[:1], kept[0][1]))
        decoder_ms = device_ms(torch, lambda: tr_dense_apply(
            qpk["decoder"], qc["decoder"], qs["decoder"], h_last, False))
        host_ms = seconds / GEN_WORDS * 1e3
        results[name] = dict(
            pack=pack, unquantized_dtype=half, steps=GEN_WORDS, batch=BATCH,
            seconds=seconds, run_seconds=runs,
            tokens_per_s=BATCH * GEN_WORDS / seconds,
            steps_per_s=GEN_WORDS / seconds, host_ms_per_step=host_ms,
            device_ms_per_step=step_ms, decoder_ms=decoder_ms,
            device_idle_share=1.0 - step_ms / host_ms,
            launches_by_variant=variants,
            launches={k: v for k, v in launches.items() if v},
            teacher_steps=len(kept), logp_max_abs_err=step_err,
            hidden_max_abs_err=hidden_err,
            free_running_logp_max_abs_err=free_err,
            rows_with_boundary_flip=int(flipped.sum()),
            first_tokens=toks[1:9, 0].tolist())
    emit({"phase": "lstm_batch_serving", "ok": True, "nvidia_smi": smi,
          "sf": {k: float(qs[k]["sf"]) for k in ("rnn", "decoder")},
          "results": results, "step_graphs": _graph_counts(graphs0)})
    return _sum_counts(*counts)


# --------------------------------------------------------------- phase 36


def _graph_counts(before: dict) -> dict:
    """``STEP_GRAPHS.counts`` since ``before`` (a copy of them), in all
    and by step name."""
    from tq_tpu_torch.utils.graphs import STEP_GRAPHS

    def since(now, then):
        then = then or {"captures": 0, "replays": 0, "eager": {}}
        return {"captures": now["captures"] - then["captures"],
                "replays": now["replays"] - then["replays"],
                "eager": {k: n - then["eager"].get(k, 0)
                          for k, n in now["eager"].items()}}

    now = STEP_GRAPHS.counts
    return {**since(now, before),
            "steps": {k: since(c, before["steps"].get(k))
                      for k, c in now["steps"].items()}}


def _graph_counts_now() -> dict:
    """A copy of ``STEP_GRAPHS.counts``: in all and by step name."""
    import copy

    from tq_tpu_torch.utils.graphs import STEP_GRAPHS

    return copy.deepcopy(STEP_GRAPHS.counts)


def phase_lstm_graph(torch, ckpt: Path, smi: str):
    """The LSTM LM's quantized step through its CUDA graph
    (``utils/graphs.py``) at batch 1 and 64, on the serving cells' model
    (u8s-packed, the recurrent weights too, raw decoder input): GEN_STEPS
    chained greedy steps of ``make_quantized_apply``'s forward against
    the eager step (``lstm_lm.quantized_step``) on the card, bit for bit
    (log-probs, h and c); host us a step of each (the call alone, and
    GEN_WORDS steps to a synchronize, median of three runs); device us a
    step (the eager step's launches captured by ``device_ms``); launches
    a step, eager and replayed, equal; the counter: one capture a batch,
    every later step a replay."""
    from tq_tpu_torch.evals.generate import serving_model
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.utils.params import params_from_jax

    params_np, stream = _lstm_inputs(ckpt)
    params = params_from_jax(params_np, "cuda")
    qp, qc, qs = serving_model(params, (8, 8, 24, 8, 8), "u8s", stream)
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    H = qp["rnn"][0]["b_hh"].shape[0] // 4

    def eager(tok, hidden):
        return lstm_lm.quantized_step(qp, qc, qs, tok, hidden, False)[:2]

    def graphed(tok, hidden):
        return fwd(qp, qs, tok, hidden)[:2]

    def chain(step, tok, steps: int, keep: bool):
        """``steps`` greedy steps from ``tok``: (the steps' outputs if
        ``keep``, host seconds in the calls, seconds to a synchronize)."""
        hidden = lstm_lm.init_hidden(tok.shape[1], nhid=H, device="cuda")
        kept, in_calls = [], 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            t1 = time.perf_counter()
            logp, hidden = step(tok, hidden)
            in_calls += time.perf_counter() - t1
            tok = logp.argmax(-1).reshape(1, -1)
            if keep:
                kept.append((logp, *hidden))
        torch.cuda.synchronize()
        return kept, in_calls, time.perf_counter() - t0

    results = {}
    for batch in (1, BATCH):
        start = torch.as_tensor(np.random.default_rng(GEN_SEED).integers(
            0, VOCAB, (1, batch)), device="cuda")
        before = _graph_counts_now()
        want, _, _ = chain(eager, start, GEN_STEPS, True)
        got, _, _ = chain(graphed, start, GEN_STEPS, True)
        for i, (a, b) in enumerate(zip(got, want)):
            for name, x, y in zip(("log-probs", "h", "c"), a, b):
                if not torch.equal(x, y):
                    fail(f"lstm graph B={batch}: step {i}'s {name} differ "
                         f"from the eager step's by "
                         f"{float((x - y).abs().max())}")
        counts = _graph_counts(before)
        if counts["captures"] != 1 or counts["replays"] != GEN_STEPS - 1:
            fail(f"lstm graph B={batch}: {counts}, not one capture and "
                 f"{GEN_STEPS - 1} replays")
        launches = {}
        for name, step in (("eager", eager), ("graph", graphed)):
            (_, _, _), launches[name] = _counted(
                torch, chain, step, start, 1, False)
        if launches["eager"] != launches["graph"]:
            fail(f"lstm graph B={batch}: launches a step eager "
                 f"{launches['eager']}, replayed {launches['graph']}")
        timed = {}
        for name, step in (("eager", eager), ("graph", graphed)):
            runs = [chain(step, start, GEN_WORDS, False)[1:]
                    for _ in range(3)]
            timed[name] = {
                "host_us": float(np.median([r[0] for r in runs]))
                / GEN_WORDS * 1e6,
                "wall_us": float(np.median([r[1] for r in runs]))
                / GEN_WORDS * 1e6}
        hidden = lstm_lm.init_hidden(batch, nhid=H, device="cuda")
        device_us = device_ms(torch, lambda: eager(start, hidden)) * 1e3
        results[f"B{batch}"] = {
            "eager_host_us": timed["eager"]["host_us"],
            "eager_wall_us": timed["eager"]["wall_us"],
            "graph_host_us": timed["graph"]["host_us"],
            "graph_wall_us": timed["graph"]["wall_us"],
            "device_us": device_us, "bit_for_bit_steps": GEN_STEPS,
            "launches_a_step": {k: v for k, v in launches["graph"].items()
                                if v}, "counts": counts}
    emit({"phase": "lstm_graph", "ok": True, "nvidia_smi": smi,
          "results": results, "counts": _graph_counts_now()})


# --------------------------------------------------------------- phase 10


def _exact(torch, name, got, want):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"{name}: {bad} of {want.numel()} values differ from the "
             "plain version")


def phase_cnn_kernels(torch):
    """The tr_quantize bodies and tr_scale_copy at the ResNet-18 shapes:
    B1 on the four activation shapes in float32 and bfloat16 (and the int32
    variants), B2 on every converted conv's HWIO weight (g=8 along axis 2),
    B5 on the B1 input; bit for bit against the plain versions, timed by
    CUDA-graph replay beside the bound."""
    from tq_tpu_torch.kernels.tr_quantize import (max_hese_terms, tr_quantize,
                                                  tr_quantize_int,
                                                  tr_quantize_int_ref,
                                                  tr_quantize_ref,
                                                  tr_scale_copy,
                                                  tr_scale_copy_ref)
    from tq_tpu_torch.layers.common import weight_scale
    from tq_tpu_torch.models.resnet import conv_specs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    # The bf16 input: every q and budget for bits 1..9 at the (bf16-rounded)
    # rounding boundaries.
    n_cases = 0
    sf = torch.tensor(0.0371, device=dev)
    for bits in range(1, 10):
        x = _boundary_inputs(torch, bits, 0.0371, dev).to(torch.bfloat16)
        for budget in range(0, max_hese_terms(bits) + 2):
            for mode in ("largest", "serial"):
                _exact(torch, f"bf16 bits={bits} k={budget} {mode}",
                       tr_quantize(x, sf, bits, 1, budget, keep_mode=mode),
                       tr_quantize_ref(x, sf, bits, 1, budget,
                                       keep_mode=mode))
                _exact(torch, f"bf16 int bits={bits} k={budget} {mode}",
                       tr_quantize_int(x, sf, bits, budget, keep_mode=mode),
                       tr_quantize_int_ref(x, sf, bits, budget,
                                           keep_mode=mode))
                n_cases += 2

    # B1 (float32 and bfloat16 input, dequantized and int32 output) and B5
    # on the four ResNet-18 activation shapes at batch 64; each bit for bit
    # and timed beside its bound, B5 beside torch.mul.  The first shape
    # (layer1) is the kernels line's row, with the eager, plain and library
    # times.
    sf = torch.tensor(0.05, device=dev)
    rows, per_shape = {}, {}
    for shape in RESNET_ACTIVATIONS:
        x = torch.randn(*shape, generator=gen, device=dev) * 2
        xb = x.to(torch.bfloat16)
        n = x.numel()
        cells = {}
        for name, kernel, plain, nbytes in [
                ("tr_quantize_elementwise",
                 lambda: tr_quantize(x, sf, 9, 1, 3),
                 lambda: tr_quantize_ref(x, sf, 9, 1, 3), 8 * n),
                ("tr_quantize_elementwise_int",
                 lambda: tr_quantize_int(x, sf, 9, 3),
                 lambda: tr_quantize_int_ref(x, sf, 9, 3), 8 * n),
                ("tr_quantize_elementwise_bf16",
                 lambda: tr_quantize(xb, sf, 9, 1, 3),
                 lambda: tr_quantize_ref(xb, sf, 9, 1, 3), 4 * n),
                ("tr_quantize_elementwise_bf16_int",
                 lambda: tr_quantize_int(xb, sf, 9, 3),
                 lambda: tr_quantize_int_ref(xb, sf, 9, 3), 6 * n),
                ("tr_scale_copy", lambda: tr_scale_copy(x, sf),
                 lambda: tr_scale_copy_ref(x, sf), 8 * n)]:
            out, ref = kernel(), plain()
            _exact(torch, f"{name} {list(shape)}", out, ref)
            b, by = bound_ms(nbytes, 6 * n)
            cell = dict(shape=list(shape), bits=9, terms=3,
                        max_abs_err=float((out.float() - ref.float())
                                          .abs().max()),
                        bound_ms=b, bound_by=by)
            library = (lambda: torch.mul(x, sf)) if name == "tr_scale_copy" \
                else None
            cell.update(timings(torch, kernel, plain, library))
            if shape == RESNET_ACTIVATIONS[0]:
                rows[name] = cell
            cells[name] = {k: cell[k] for k in ("ms", "eager_ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "bound_by", "max_abs_err")}
        per_shape["x".join(map(str, shape))] = cells
    for name in ("tr_quantize_elementwise", "tr_quantize_elementwise_bf16"):
        rows[name]["copy_ceiling_ms"] = rows["tr_scale_copy"]["ms"]
        rows[name + "_int"]["copy_ceiling_ms"] = rows["tr_scale_copy"]["ms"]
        rows[name]["per_shape"] = {
            s: {"ms": c[name]["ms"], "eager_ms": c[name]["eager_ms"],
                "plain_ms": c[name]["plain_ms"],
                "int_out_ms": c[name + "_int"]["ms"],
                "bound_ms": c[name]["bound_ms"],
                "int_out_bound_ms": c[name + "_int"]["bound_ms"],
                "copy_ceiling_ms": c["tr_scale_copy"]["ms"]}
            for s, c in per_shape.items()}
    rows["tr_scale_copy"]["per_shape"] = {
        s: {k: c["tr_scale_copy"][k] for k in ("ms", "eager_ms", "plain_ms",
                                               "library_ms", "bound_ms")}
        for s, c in per_shape.items()}

    # B2 on every converted conv's weight shape, at the flagship's (9, 8, 12)
    # and a published-grid TR row, both keep modes.
    g_cases = 0
    weights = {}
    for spec in conv_specs()[1:]:
        shape = (spec.kh, spec.kw, spec.in_ch, spec.out_ch)
        if shape not in weights:
            weights[shape] = torch.randn(*shape, generator=gen, device=dev) \
                * (2.0 / (spec.kh * spec.kw * spec.out_ch)) ** 0.5
        w = weights[shape]
        wsf = weight_scale(w, 9)
        for wt in (12, 16):
            for mode in ("largest", "serial"):
                _exact(torch, f"grouped {shape} wt={wt} {mode}",
                       tr_quantize(w, wsf, 9, 8, wt, 2, mode),
                       tr_quantize_ref(w, wsf, 9, 8, wt, 2, mode))
                g_cases += 1
    # Each conv shape's times and bound, and B2's device time a sweep
    # setting (the converted convs at the flagship's setting).
    per_conv = {}
    for shape, w in weights.items():
        wsf = weight_scale(w, 9)
        per_conv["x".join(map(str, shape))] = dict(
            **timings(torch, lambda: tr_quantize(w, wsf, 9, 8, 12, 2),
                      lambda: tr_quantize_ref(w, wsf, 9, 8, 12, 2)),
            bound_ms=bound_ms(8 * w.numel(), 0)[0])
    setting_ms = sum(per_conv["x".join(map(str, (s.kh, s.kw, s.in_ch,
                                                  s.out_ch)))]["ms"]
                     for s in conv_specs()[1:])
    w = weights[(3, 3, 512, 512)]
    wsf = weight_scale(w, 9)
    nw = w.numel()
    b, by = bound_ms(8 * nw, 6 * nw)
    rows["tr_quantize_grouped"] = dict(
        shape=[3, 3, 512, 512], group_size=8, axis=2, bits=9, terms=12,
        cases=g_cases, max_abs_err=0.0,
        **timings(torch, lambda: tr_quantize(w, wsf, 9, 8, 12, 2),
                  lambda: tr_quantize_ref(w, wsf, 9, 8, 12, 2)),
        # B5 on as many elements: what B2's 8 bytes an element cost alone.
        copy_ceiling_ms=device_ms(torch, lambda: tr_scale_copy(w, wsf)),
        per_shape=per_conv, sweep_setting_ms=setting_ms,
        bound_ms=b, bound_by=by)
    emit({"phase": "cnn_kernels", "ok": True, "bf16_cases": n_cases,
          "results": rows})
    return rows


# --------------------------------------------------------------- phase 11


def _record_convs(torch, model, qp, qc, qs, x, compute_dtype=None):
    """(logits, {name: (input, stride, padding, groups)} of each converted
    conv) of the eval forward (``make_cnn_apply``'s, in float32 or
    ``compute_dtype``)."""
    from tq_tpu_torch.convert import make_cnn_apply
    from tq_tpu_torch.layers.qctx import QuantCtx

    seen = {}

    class Recorder(QuantCtx):
        def conv(self, name, params, x, stride=(1, 1), padding="SAME",
                 groups=1):
            if name in self.cfg:
                seen[name] = (x, stride, padding, groups)
            return super().conv(name, params, x, stride, padding, groups)

    logits, _ = make_cnn_apply(model, qc, track=False,
                               compute_dtype=compute_dtype,
                               context=Recorder)(qp, qs, x)
    return logits, seen


# The UQ setting of int8 serving, as the JAX package's
# bench_resnet(int8=True, uq=True): (wb, gs, wt) and (db, dt).
INT8_UQ = ((7, 1, 7), (7, 5))


def _int8_held(torch, model, qp, packed, qc, qs, x, limit: float,
               what: str, timed: bool = False, flip_limit: float = None):
    """The int8 serving forms of a UQ model packed by ``pack_cnn``, on the
    card at ``x`` (uncounted).  In float32 and bfloat16, on each form's
    own inputs: B1's int32-output variant bit for bit with its plain
    version, and every int8 conv bit for bit with a float64 conv of the
    same codes (exact: |code| <= 127, |w| <= 127 and K <= 4,608, so every
    sum is an integer below 2^53).  Each int8 conv within LAYER_RTOL of
    the float32 UQ conv on the UQ forward's input.  Between the int8 and
    the float32 UQ forwards every converted conv's input codes are
    compared: where a code differs, the signed uniform code must differ
    too (a flip at a rounding boundary, or one carried on from an earlier
    layer), the flips counted per image.  The
    int8 logits within ``limit`` of max |logit| of the float32 UQ
    model's on images without a flip, within ``flip_limit`` (default
    ``limit``) on the others; the bf16 form's
    float32 logits finite and within 0.2 (relative norm) of the float32
    form's.  ``timed``: also B1's int32-output variants timed at the
    first int8 conv's input, beside the byte bound (returned as kernel
    cells)."""
    from tq_tpu_torch.kernels.tr_quantize import (tr_quantize_int,
                                                  tr_quantize_int_ref)
    from tq_tpu_torch.layers.conv import conv2d, int8_conv2d, tr_conv_apply
    from tq_tpu_torch.ops.term_reveal import uniform_quantize

    int8 = [n for n in qc if packed[n]["w"].dtype == torch.int8]
    logits_uq, seen_uq = _record_convs(torch, model, qp, qc, qs, x)
    forms = {"f32": _record_convs(torch, model, packed, qc, qs, x),
             "bf16": _record_convs(torch, model, packed, qc, qs, x,
                                   torch.bfloat16)}
    nonzero = {}
    for form, (_, seen) in forms.items():
        codes = total = 0
        for n in int8:
            xin, stride, padding, groups = seen[n]
            tr = qc[n]
            xi = tr_quantize_int(xin, qs[n]["sf"], tr.data_bits,
                                 tr.data_terms)
            _exact(torch, f"{what} int8 {form} {n} codes", xi,
                   tr_quantize_int_ref(xin, qs[n]["sf"], tr.data_bits,
                                       tr.data_terms))
            xi = xi.to(torch.int8)
            got = int8_conv2d(xi, packed[n]["w"], stride, padding, groups)
            ref = conv2d(xi.double(), packed[n]["w"].double(), stride,
                         padding, groups)
            torch.cuda.synchronize()
            if got.dtype != torch.int32 or not torch.equal(got.double(),
                                                           ref):
                fail(f"{what} int8 {form} {n}: the int8 conv differs from "
                     "the float64 conv of the same codes")
            codes += int((xi != 0).sum())
            total += xi.numel()
        nonzero[form] = codes / total
    layer_err = 0.0
    for n in int8:
        xin, stride, padding, groups = seen_uq[n]
        y8, _ = tr_conv_apply(packed[n], qc[n], qs[n], xin, False, stride,
                              padding, groups)
        y32, _ = tr_conv_apply(qp[n], qc[n], qs[n], xin, False, stride,
                               padding, groups)
        err = float((y8 - y32).abs().max()) / max(float(y32.abs().max()),
                                                  1e-30)
        if err > LAYER_RTOL:
            fail(f"{what} int8 {n}: {err} (relative) from the float32 UQ "
                 "conv on the same input")
        layer_err = max(layer_err, err)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    flips = 0
    for n, tr in qc.items():
        xa, xb = forms["f32"][1][n][0], seen_uq[n][0]
        differ = (tr_quantize_int(xa, qs[n]["sf"], tr.data_bits,
                                  tr.data_terms)
                  != tr_quantize_int(xb, qs[n]["sf"], tr.data_bits,
                                     tr.data_terms))
        # The kept terms are a function of the signed uniform code: where
        # the codes differ, it differs too (a flip at a rounding boundary,
        # or an earlier layer's flip carried on).
        ua, sa = uniform_quantize(xa[differ], qs[n]["sf"], tr.data_bits)
        ub, sb = uniform_quantize(xb[differ], qs[n]["sf"], tr.data_bits)
        if bool((ua * sa == ub * sb).any()):
            fail(f"{what} int8 {n}: an input code differs from the float32 "
                 "UQ forward's where the uniform codes agree")
        flips += int(differ.sum())
        flipped |= differ.reshape(x.shape[0], -1).any(dim=1)
    logits8, logits_bf16 = forms["f32"][0], forms["bf16"][0]
    for form, t in (("f32", logits8), ("bf16", logits_bf16)):
        if t.dtype != torch.float32 or not bool(torch.isfinite(t).all()):
            fail(f"{what} int8 {form}: logits of type {t.dtype}, or not "
                 "finite")
    row_gap = ((logits8 - logits_uq).abs().max(dim=1).values
               / logits_uq.abs().max())
    flip_limit = limit if flip_limit is None else flip_limit
    gap = float(row_gap.max())
    gap_unflipped = float(row_gap[~flipped].max()) if bool(
        (~flipped).any()) else 0.0
    if gap_unflipped > limit or gap > flip_limit:
        fail(f"{what} int8: logits {gap} of max |logit| from the float32 UQ "
             f"model's ({gap_unflipped} on images without a flip; limits "
             f"{limit}, {flip_limit} with a flip; {flips} flips)")
    bf16_rel = float((logits_bf16 - logits8).norm() / logits8.norm())
    if bf16_rel >= 0.2:
        fail(f"{what} int8 bf16: {bf16_rel} (relative norm) from the "
             "float32 int8 form")
    out = dict(int8_layers=len(int8), nonzero_code_share=nonzero,
               layer_max_rel_err_vs_uq=layer_err, boundary_flips_vs_uq=flips,
               images_flipped=int(flipped.sum()),
               logit_max_rel_err_vs_uq=gap,
               logit_max_rel_err_vs_uq_unflipped=gap_unflipped, limit=limit,
               flip_limit=flip_limit,
               top1_agree_vs_uq=int((logits8.argmax(1)
                                     == logits_uq.argmax(1)).sum()),
               bf16_vs_f32_rel_norm=bf16_rel)
    if not timed:
        return out, {}
    xin = forms["f32"][1][int8[0]][0]
    xb = forms["bf16"][1][int8[0]][0]
    sf, tr = qs[int8[0]]["sf"], qc[int8[0]]
    n_el = xin.numel()
    cells = {}
    for row, xs, nbytes in (("tr_quantize_elementwise_int", xin, 8 * n_el),
                            ("tr_quantize_elementwise_bf16_int", xb,
                             6 * n_el)):
        b, by = bound_ms(nbytes, 6 * n_el)
        cells[row] = {f"{what} {'x'.join(map(str, xs.shape))}": dict(
            shape=list(xs.shape), bits=tr.data_bits, terms=tr.data_terms,
            max_abs_err=0.0, bound_ms=b, bound_by=by,
            **timings(torch, lambda xs=xs: tr_quantize_int(
                xs, sf, tr.data_bits, tr.data_terms),
                lambda xs=xs: tr_quantize_int_ref(
                    xs, sf, tr.data_bits, tr.data_terms)))}
    return out, cells


def _with_sf(torch, qstate, sf: float):
    return {k: {**v, "sf": torch.tensor(sf, device=v["sf"].device)}
            for k, v in qstate.items()}


def _images_per_s(torch, fn, batch: int, reps: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


# Tolerances of the flagship.  Each converted conv's output on the same
# input, relative to max |y|: float32 sums in another order (cuDNN against
# the CPU's convolution).  The logits relative to max |logit|: end to end,
# a quantized input that flips at a rounding boundary of |x| / sf spreads
# to every later layer in its receptive field.  On an NVIDIA H100 80GB HBM3
# (700 W) the logits came within 3.4e-3 of the CPU plain path's; the limit
# leaves room for 3x that.
LOGIT_RTOL = 1e-2
LAYER_RTOL = 1e-5


def phase_flagship(torch, ckpt: Path):
    """The JAX package's entry() program (TR ResNet-18, wb=9, g=8, wt=12,
    db=9, dt=3, every sf 0.05) at 224x224 on the card, through the port's
    entry points; then its bf16 serving mode and the int8-packed UQ model
    (wb=db=7, g=1, wt=7, dt=5) in float32 and bfloat16.  Held against the
    CPU plain path layer by layer and against the JAX package's numbers
    (EXPECTED_CNN); the int8 forms by ``_int8_held``."""
    from tq_tpu_torch.convert import (convert_cnn, make_cnn_apply, pack_cnn,
                                      static_conv_layer_settings)
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.layers.conv import tr_conv_apply
    from tq_tpu_torch.models import resnet
    from tq_tpu_torch.ops.term_reveal import uniform_quantize

    f = FLAGSHIP
    x_np = np.random.default_rng(0).normal(
        size=(f["batch"], f["image"], f["image"], 3)).astype(np.float32)
    tr_settings = static_conv_layer_settings(resnet.conv_specs(), *f["tr"])
    uq_settings = static_conv_layer_settings(resnet.conv_specs(),
                                             *INT8_UQ[0])

    # The main path, counted: convert, the float32 program, the bf16
    # serving mode, the int8-packed UQ model in float32 and bfloat16.
    _reset_counts()
    t0 = time.perf_counter()
    _, params = load_params("resnet18", str(ckpt), device="cuda")
    qp, qc, qs = convert_cnn(resnet, params, tr_settings, f["db"], f["dt"])
    qs = _with_sf(torch, qs, f["sf"])
    x = torch.as_tensor(x_np, device="cuda")
    logits, _ = make_cnn_apply(resnet, qc, track=False)(qp, qs, x)
    logits_bf16, _ = make_cnn_apply(resnet, qc, track=False,
                                    compute_dtype=torch.bfloat16)(qp, qs, x)
    uqp, uqc, uqs = convert_cnn(resnet, params, uq_settings, *INT8_UQ[1])
    uqs = _with_sf(torch, uqs, f["sf"])
    packed = pack_cnn(uqp, uqc)
    logits_int8, _ = make_cnn_apply(resnet, uqc, track=False)(packed, uqs, x)
    logits_int8_bf16, _ = make_cnn_apply(resnet, uqc, track=False,
                                         compute_dtype=torch.bfloat16)(
        packed, uqs, x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_elementwise_bf16",
                                 "tr_quantize_elementwise_int",
                                 "tr_quantize_elementwise_bf16_int",
                                 "tr_quantize_grouped"], "ResNet flagship")
    for name, t in (("f32", logits), ("bf16", logits_bf16),
                    ("int8", logits_int8), ("int8_bf16", logits_int8_bf16)):
        if t.shape != (f["batch"], 1000) or not bool(torch.isfinite(t).all()):
            fail(f"flagship {name}: logits of shape {tuple(t.shape)}, or "
                 "not finite")

    # The same program through the CPU plain path.
    _, params_c = load_params("resnet18", str(ckpt), device="cpu")
    qp_c, _, qs_c = convert_cnn(resnet, params_c, tr_settings, f["db"],
                                f["dt"])
    qs_c = _with_sf(torch, qs_c, f["sf"])
    for name in qc:
        if not torch.equal(qp[name]["w"].cpu(), qp_c[name]["w"]):
            fail(f"flagship {name}: converted weights differ card vs cpu")
    logits_g, seen_g = _record_convs(torch, resnet, qp, qc, qs, x)
    logits_c, seen_c = _record_convs(torch, resnet, qp_c, qc, qs_c,
                                     torch.from_numpy(x_np))
    if not torch.equal(logits_g, logits):
        fail("flagship: the recorded forward differs from the model's")
    first = next(iter(qc))  # its input differs only by float32 rounding
    layer_err, flips, first_gap = {}, {}, 0.0
    for name, tr in qc.items():
        xg, stride, padding, _ = seen_g[name]
        xc = seen_c[name][0]
        # Same input (the CPU's): the quantized input exactly, the output
        # within LAYER_RTOL.
        _exact(torch, f"flagship {name} quantized input",
               tr_quantize(xc.cuda(), qs[name]["sf"], tr.data_bits, 1,
                           tr.data_terms).cpu(),
               tr_quantize(xc, qs_c[name]["sf"], tr.data_bits, 1,
                           tr.data_terms))
        yg, _ = tr_conv_apply(qp[name], tr, qs[name], xc.cuda(), False,
                              stride, padding)
        yc, _ = tr_conv_apply(qp_c[name], tr, qs_c[name], xc, False, stride,
                              padding)
        err = float((yg.cpu() - yc).abs().max() / yc.abs().max())
        if err > LAYER_RTOL:
            fail(f"flagship {name}: output differs by {err} (relative) on "
                 "the same input")
        layer_err[name] = err
        # End to end: the quantized inputs differ only where the two
        # inputs lie on two sides of a rounding boundary of |x| / sf.  The
        # first converted conv's inputs differ by float32 rounding alone
        # (the stem is unquantized), so each of its flips must sit within
        # that rounding of a .5 boundary; later layers see earlier flips.
        xg = xg.cpu()
        differ = tr_quantize(xg, qs_c[name]["sf"], tr.data_bits, 1,
                             tr.data_terms) != tr_quantize(
            xc, qs_c[name]["sf"], tr.data_bits, 1, tr.data_terms)
        qa, _ = uniform_quantize(xg[differ], qs_c[name]["sf"], tr.data_bits)
        qb, _ = uniform_quantize(xc[differ], qs_c[name]["sf"], tr.data_bits)
        if bool((qa == qb).any()):
            fail(f"flagship {name}: a quantized input differs card vs cpu "
                 "away from a rounding boundary")
        flips[name] = int(differ.sum())
        if name == first and flips[name]:
            r = xc[differ].double().abs() / f["sf"]
            first_gap = float(((r - r.floor() - 0.5).abs() / r).max())
            if first_gap > 1e-5:
                fail(f"flagship {name}: a boundary flip {first_gap} "
                     "(relative) away from the .5 boundary")
    scale = float(logits_c.abs().max())
    logit_err = float((logits.cpu() - logits_c).abs().max()) / scale
    if logit_err > LOGIT_RTOL:
        fail(f"flagship: logits differ card vs cpu by {logit_err} of "
             f"max |logit| ({sum(flips.values())} boundary flips: {flips})")

    # Against the JAX package's numbers.
    exp = EXPECTED_CNN["flagship"]
    lg = logits.cpu().double()
    jax_err = max(
        abs(float(lg.mean()) - exp["mean"]),
        abs(float(lg.std(correction=0)) - exp["std"]),
        abs(float(lg.abs().max()) - exp["max_abs"]),
        float((lg.max(1).values - torch.tensor(exp["row_max"])).abs().max()),
        float((lg[0, :8] - torch.tensor(exp["first"])).abs().max()))
    jax_err /= exp["max_abs"]
    if jax_err > LOGIT_RTOL:
        fail(f"flagship: logit statistics differ from the JAX package's by "
             f"{jax_err} of max |logit|")
    top1 = lg.argmax(1).tolist()
    for i, (a, b, m) in enumerate(zip(top1, exp["top1"], exp["top2_margin"])):
        if a != b and m > 2 * LOGIT_RTOL * exp["max_abs"]:
            fail(f"flagship image {i}: top-1 {a}, the JAX package's {b} "
                 f"(margin {m})")

    int8, _ = _int8_held(torch, resnet, uqp, packed, uqc, uqs, x,
                         LOGIT_RTOL, "flagship")

    def agreement(a, b):
        return dict(top1_agree=int((a.argmax(1) == b.argmax(1)).sum()),
                    max_abs_diff_rel=float((a.float() - b.float()).abs().max()
                                           / b.abs().max()))

    # Throughput at batch 64.
    x64 = torch.randn(64, f["image"], f["image"], 3, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    f32_fwd = make_cnn_apply(resnet, qc, track=False)
    bf16_fwd = make_cnn_apply(resnet, qc, track=False,
                              compute_dtype=torch.bfloat16)
    int8_fwd = make_cnn_apply(resnet, uqc, track=False)
    int8_bf16_fwd = make_cnn_apply(resnet, uqc, track=False,
                                   compute_dtype=torch.bfloat16)
    images_per_s = {
        "fp32_unquantized": _images_per_s(
            torch, lambda: resnet.apply(params, x64), 64),
        "tr_f32": _images_per_s(torch, lambda: f32_fwd(qp, qs, x64), 64),
        "tr_bf16": _images_per_s(torch, lambda: bf16_fwd(qp, qs, x64), 64),
        "uq_int8": _images_per_s(torch, lambda: int8_fwd(packed, uqs, x64),
                                 64),
        "uq_int8_bf16": _images_per_s(
            torch, lambda: int8_bf16_fwd(packed, uqs, x64), 64)}
    emit({"phase": "flagship", "ok": True, "seconds": seconds,
          "batch": f["batch"], "image": f["image"], "launches": launches,
          "layer_max_rel_err": max(layer_err.values()),
          "boundary_flips": sum(flips.values()),
          "flips_by_layer": {k: v for k, v in flips.items() if v},
          "first_layer_flip_max_rel_dist": first_gap,
          "logit_max_rel_err_vs_cpu": logit_err,
          "logit_stat_max_rel_err_vs_jax": jax_err, "top1": top1,
          "bf16_vs_f32": agreement(logits_bf16, logits),
          "int8": int8,
          "images_per_s_batch64": images_per_s})
    return launches


# --------------------------------------------------------------- phase 12


def _mse_at(torch, hist, sf: float, bits: int, terms: int) -> float:
    """The scale search's objective at one scale, in float64."""
    from tq_tpu_torch.layers.quantize import (_tr_elementwise_vals,
                                              calibration_grids)

    x_grid, _ = calibration_grids(device=hist.device)
    xh = _tr_elementwise_vals(x_grid, torch.tensor(sf, device=hist.device),
                              bits, terms)
    return float((hist.double() * (x_grid - xh).double() ** 2).sum())


def phase_cnn_sweep(torch, ckpt: Path):
    """evals/cnn.py's run_sweep('resnet18') with the published grid (15
    settings, 512 synthetic images, batch 64) on the card: tmacs,
    avg_terms and params equal to results/resnet18-results.json, and the
    flagship setting's 19 calibrated scales equal to the JAX package's (or
    near-ties on the card's histogram)."""
    from tq_tpu_torch.data.imagenet import find_imagenet_val
    from tq_tpu_torch.evals import cnn as cnn_eval

    if find_imagenet_val() is not None:
        fail("EXPECTED_CNN holds the synthetic batches' numbers; unset "
             "TQ_DATA_DIR")
    published = json.loads((ROOT / "results" / "resnet18-results.json")
                           .read_text())
    grid = cnn_eval.PUBLISHED_GRIDS["resnet18"]
    finalize = cnn_eval.finalize_cnn
    calibrated = []

    def capture(qstate, qcfg):  # the scales each setting calibrates
        out = finalize(qstate, qcfg)
        calibrated.append((qcfg, out))
        return out

    _reset_counts()
    cnn_eval.finalize_cnn = capture
    try:
        t0 = time.perf_counter()
        got = cnn_eval.run_sweep("resnet18", checkpoint=str(ckpt),
                                 batch_size=64, n_synth=512, verbose=False,
                                 device="cuda", **grid)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cnn_eval.finalize_cnn = finalize
    launches = _read_counts()
    for key, cols in got.items():
        for col in ("tmacs", "avg_terms", "params"):
            if cols[col] != published[key][col]:
                fail(f"resnet18 sweep {key} {col}: {cols[col]} != "
                     f"published {published[key][col]}")
    exp = EXPECTED_CNN["sweep_sf"]
    wb, gs, wt, db, dt = exp["setting"]
    match = [st for qcfg, st in calibrated if all(
        (t.weight_bits, t.group_size, t.weight_terms, t.data_bits,
         t.data_terms) == (wb, gs, wt, db, dt) for t in qcfg.values())]
    if len(match) != 1:
        fail(f"setting {exp['setting']} calibrated {len(match)} times")
    near_ties = {}
    for name, want in exp["sf"].items():
        have = float(match[0][name]["sf"])
        if have != want:
            hist = match[0][name]["hist"]
            ea, eb = (_mse_at(torch, hist, v, db, dt) for v in (have, want))
            if abs(ea - eb) > 1e-6 * max(ea, eb):
                fail(f"resnet18 sweep {name}: calibrated sf {have} != the "
                     f"JAX package's {want} (errors {ea}, {eb})")
            near_ties[name] = dict(card=have, jax=want, err_card=ea,
                                   err_jax=eb)
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_grouped", "histogram"],
                      "ResNet sweep")
    t1 = time.perf_counter()
    list(cnn_eval._batches("resnet18", None, 64, 512))
    data_seconds = time.perf_counter() - t1
    emit({"phase": "cnn_sweep", "ok": True, "seconds": seconds,
          "settings": sum(len(v["accs"]) for v in got.values()),
          "data_seconds_per_setting": data_seconds,
          "sf_equal": len(exp["sf"]) - len(near_ties),
          "sf_near_ties": near_ties, "launches": launches,
          "accs": {k: v["accs"] for k, v in got.items()}})
    return launches


# --------------------------------------------------------------- phase 13


# The zoo's largest activations at batch 64 (NHWC): VGG's first block, and
# MobileNet's and EfficientNet's stage-2 expansion outputs.
ZOO_ACTIVATIONS = [(64, 224, 224, 64), (64, 112, 112, 96)]
# The exempt depthwise weights that B1 reveals at (16, 1, 16): MobileNet's
# widest and EfficientNet's widest 5x5.
ZOO_EXEMPT_WEIGHTS = [(3, 3, 1, 960), (5, 5, 1, 1152)]
# EfficientNet's squeeze-excite widths: its (N, 1, 1, C) inputs.
SE_WIDTHS = (4, 6, 10, 20)
# The zoo's largest 1x1 weight (EfficientNet's last projection).
ZOO_GROUPED = (1, 1, 1152, 320)


def _cell(torch, kernel, plain, nbytes: float, n: int, big: bool = False):
    """A per-shape cell: device, eager and plain times beside the bound
    (the plain version of a large shape on fewer captured calls)."""
    b, by = bound_ms(nbytes, 6 * n)
    return dict(ms=device_ms(torch, kernel), eager_ms=eager_ms(torch, kernel),
                plain_ms=(device_ms(torch, plain, calls=2, replays=3) if big
                          else device_ms(torch, plain)),
                bound_ms=b, bound_by=by)


def phase_zoo_kernels(torch):
    """B1 and B2 at the CNN zoo's shapes, bit for bit against the plain
    versions first, then timed (device, eager, plain) beside the bound: B1
    in float32 and bfloat16 on ZOO_ACTIVATIONS (signed: swish outputs on
    the second); B1 at bits 16 with 16 terms on the exempt depthwise
    weights; B1 on squeeze-excite inputs (64, 1, 1, C); B2 at g = 2 and 32
    (the generic instantiation) on (3, 3, 512, 512) at every alpha of the
    group-size grid, and at g = 8 on the zoo's largest 1x1 weight, both
    keep modes."""
    from tq_tpu_torch.evals.group_size import ALPHAS
    from tq_tpu_torch.kernels.tr_quantize import (tr_quantize,
                                                  tr_quantize_ref,
                                                  tr_scale_copy)
    from tq_tpu_torch.layers.common import weight_scale

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    sf = torch.tensor(0.05, device=dev)
    modes = ("largest", "serial")
    cases = 0
    elementwise, bf16, grouped = {}, {}, {}
    for i, shape in enumerate(ZOO_ACTIVATIONS):
        x = torch.randn(*shape, generator=gen, device=dev) * 2
        if i == 1:
            x = torch.nn.functional.silu(x)
        key = "x".join(map(str, shape))
        for xs, cells in ((x, elementwise), (x.to(torch.bfloat16), bf16)):
            for mode in modes:
                _exact(torch, f"zoo {xs.dtype} {key} {mode}",
                       tr_quantize(xs, sf, 9, 1, 3, keep_mode=mode),
                       tr_quantize_ref(xs, sf, 9, 1, 3, keep_mode=mode))
                cases += 1
            n = xs.numel()
            cells[key] = dict(
                bits=9, terms=3, signed=True, swish=i == 1,
                **_cell(torch, lambda: tr_quantize(xs, sf, 9, 1, 3),
                        lambda: tr_quantize_ref(xs, sf, 9, 1, 3),
                        2 * n * xs.element_size(), n, big=True))
            del xs
        del x
        torch.cuda.empty_cache()
    for shape in ZOO_EXEMPT_WEIGHTS:
        w = torch.randn(*shape, generator=gen, device=dev) \
            * (2.0 / (shape[0] * shape[1])) ** 0.5
        wsf = weight_scale(w, 16)
        for mode in modes:
            _exact(torch, f"zoo exempt {shape} bits=16 k=16 {mode}",
                   tr_quantize(w, wsf, 16, 1, 16, keep_mode=mode),
                   tr_quantize_ref(w, wsf, 16, 1, 16, keep_mode=mode))
            cases += 1
        elementwise["x".join(map(str, shape))] = dict(
            bits=16, terms=16, **_cell(
                torch, lambda: tr_quantize(w, wsf, 16, 1, 16),
                lambda: tr_quantize_ref(w, wsf, 16, 1, 16), 8 * w.numel(),
                w.numel()))
    for c in SE_WIDTHS:
        x = torch.nn.functional.silu(
            torch.randn(64, 1, 1, c, generator=gen, device=dev) * 3)
        for xs in (x, x.to(torch.bfloat16)):
            for mode in modes:
                _exact(torch, f"zoo squeeze-excite {xs.dtype} width {c} "
                       f"{mode}", tr_quantize(xs, sf, 9, 1, 3, keep_mode=mode),
                       tr_quantize_ref(xs, sf, 9, 1, 3, keep_mode=mode))
                cases += 1
    w = torch.randn(3, 3, 512, 512, generator=gen, device=dev) \
        * (2.0 / (9 * 512)) ** 0.5
    wsf = weight_scale(w, 9)
    for g in (2, 32):
        for alpha in ALPHAS:
            for mode in modes:
                wt = round(alpha * g)
                _exact(torch, f"zoo grouped (3, 3, 512, 512) g={g} wt={wt} "
                       f"{mode}", tr_quantize(w, wsf, 9, g, wt, 2, mode),
                       tr_quantize_ref(w, wsf, 9, g, wt, 2, mode))
                cases += 1
        wt = round(1.5 * g)
        grouped[f"3x3x512x512_g{g}"] = dict(
            group_size=g, bits=9, terms=wt, **_cell(
                torch, lambda: tr_quantize(w, wsf, 9, g, wt, 2),
                lambda: tr_quantize_ref(w, wsf, 9, g, wt, 2), 8 * w.numel(),
                w.numel()),
            copy_ceiling_ms=device_ms(torch, lambda: tr_scale_copy(w, wsf)))
    w = torch.randn(*ZOO_GROUPED, generator=gen, device=dev) \
        * (2.0 / 320) ** 0.5
    wsf = weight_scale(w, 9)
    for mode in modes:
        _exact(torch, f"zoo grouped {ZOO_GROUPED} g=8 {mode}",
               tr_quantize(w, wsf, 9, 8, 12, 2, mode),
               tr_quantize_ref(w, wsf, 9, 8, 12, 2, mode))
        cases += 1
    grouped["x".join(map(str, ZOO_GROUPED)) + "_g8"] = dict(
        group_size=8, bits=9, terms=12, **_cell(
            torch, lambda: tr_quantize(w, wsf, 9, 8, 12, 2),
            lambda: tr_quantize_ref(w, wsf, 9, 8, 12, 2), 8 * w.numel(),
            w.numel()),
        copy_ceiling_ms=device_ms(torch, lambda: tr_scale_copy(w, wsf)))
    rows = {"tr_quantize_elementwise": elementwise,
            "tr_quantize_elementwise_bf16": bf16,
            "tr_quantize_grouped": grouped}
    emit({"phase": "zoo_kernels", "ok": True, "cases": cases, "results": rows})
    return rows


# --------------------------------------------------------------- phase 14


# The zoo's logits against the JAX package's (EXPECTED_ZOO), relative to
# max |logit|: ResNet-18's LOGIT_RTOL, wider for two archs (PERF.md section
# 2; each conv is held within LAYER_RTOL on the same input first).  On an
# NVIDIA H100 80GB HBM3 (700 W): VGG's rounding-boundary flips compound
# through its 12 converted convs at 224 px (13,315 card against CPU on two
# images) to 4.6e-2; AlexNet's card and CPU paths agree within 1e-6 with
# no flip, and both sit 8.5e-3 from the JAX package's logits (flips
# between XLA's and PyTorch's float32 sums).  MobileNet measured 4.5e-3,
# EfficientNet 2.5e-16.  Each wider limit leaves room for 3x the reading.
ZOO_LOGIT_RTOL = {"vgg16_bn": 1.5e-1, "mobilenet_v2": LOGIT_RTOL,
                  "efficientnet_b0": LOGIT_RTOL, "alexnet": 3e-2}
# The int8 logits against the float32 UQ model's on an image where some
# conv's input code flipped at a rounding boundary between the two: the
# bound of tests/test_torch_port_zoo.py's LOGIT_RTOL for such an image
# where it exceeds ZOO_LOGIT_RTOL (MobileNet-v2's 52 layers: 1e-1).
ZOO_FLIP_RTOL = {**ZOO_LOGIT_RTOL, "mobilenet_v2": 1e-1}
# Images of the pinned program held card against CPU layer by layer.
ZOO_CPU_IMAGES = 2


def _zoo_layerwise(torch, m, settings, ckpt: Path, qp, qc, qs, x,
                   arch: str):
    """Each converted conv of the card's program against the CPU plain
    path on the CPU's own inputs (the first ZOO_CPU_IMAGES images): the
    quantized input exact, the output within LAYER_RTOL; the boundary
    flips between the card's and the CPU's inputs counted; the logits'
    gap."""
    from tq_tpu_torch.convert import convert_cnn
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.layers.conv import tr_conv_apply

    f = ZOO_PROGRAM
    _, params_c = load_params(arch, str(ckpt), device="cpu")
    qp_c, _, qs_c = convert_cnn(m, params_c, settings, f["db"], f["dt"])
    qs_c = _with_sf(torch, qs_c, f["sf"])
    for name in qc:
        if not torch.equal(qp[name]["w"].cpu(), qp_c[name]["w"]):
            fail(f"{arch} {name}: converted weights differ card vs cpu")
    k = ZOO_CPU_IMAGES
    logits_g, seen_g = _record_convs(torch, m, qp, qc, qs, x)
    logits_c, seen_c = _record_convs(torch, m, qp_c, qc, qs_c, x[:k].cpu())
    layer_err, flips = {}, {}
    for name, tr in qc.items():
        xc, stride, padding, groups = seen_c[name]
        _exact(torch, f"{arch} {name} quantized input",
               tr_quantize(xc.cuda(), qs[name]["sf"], tr.data_bits, 1,
                           tr.data_terms).cpu(),
               tr_quantize(xc, qs_c[name]["sf"], tr.data_bits, 1,
                           tr.data_terms))
        yg, _ = tr_conv_apply(qp[name], tr, qs[name], xc.cuda(), False,
                              stride, padding, groups)
        yc, _ = tr_conv_apply(qp_c[name], tr, qs_c[name], xc, False, stride,
                              padding, groups)
        err = float((yg.cpu() - yc).abs().max() / yc.abs().max())
        if err > LAYER_RTOL:
            fail(f"{arch} {name}: output differs by {err} (relative) on the "
                 "same input")
        layer_err[name] = err
        xg = seen_g[name][0][:k].cpu()
        flips[name] = int((tr_quantize(xg, qs_c[name]["sf"], tr.data_bits, 1,
                                       tr.data_terms) != tr_quantize(
            xc, qs_c[name]["sf"], tr.data_bits, 1, tr.data_terms)).sum())
    gap = float((logits_g[:k].cpu() - logits_c).abs().max()
                / logits_c.abs().max())
    return logits_g, dict(layer_max_rel_err=max(layer_err.values()),
                          boundary_flips=sum(flips.values()),
                          flips_by_layer={n: v for n, v in flips.items()
                                          if v},
                          logit_max_rel_err_vs_cpu=gap)


def _vs_jax(torch, logits, exp, limit: float) -> tuple[float, list]:
    """The logits' statistics against the JAX package's, relative to its
    max |logit|, and what misses: the statistics beyond ``limit``, a top-1
    other than JAX's where the JAX margin exceeds twice the limit."""
    lg = logits.cpu().double()
    err = max(
        abs(float(lg.mean()) - exp["mean"]),
        abs(float(lg.std(correction=0)) - exp["std"]),
        abs(float(lg.abs().max()) - exp["max_abs"]),
        float((lg.max(1).values - torch.tensor(exp["row_max"])).abs().max()),
        float((lg[0, :8] - torch.tensor(exp["first"])).abs().max()))
    err /= exp["max_abs"]
    misses = []
    if err > limit:
        misses.append(f"logit statistics differ from the JAX package's by "
                      f"{err} of max |logit| (limit {limit})")
    for i, (a, b, mg) in enumerate(zip(lg.argmax(1).tolist(), exp["top1"],
                                       exp["top2_margin"])):
        if a != b and mg > 2 * limit * exp["max_abs"]:
            misses.append(f"image {i}: top-1 {a}, the JAX package's {b} "
                          f"(margin {mg})")
    return err, misses


def _sweep_columns_hold(arch: str, out_file: Path) -> None:
    """tmacs, avg_terms and params of the card's sweep equal
    ``results/<arch>-results.json`` (the JAX package's sweeps), and the
    port's compare finds no mismatch; AlexNet's also equal the JAX
    package's pinned in EXPECTED_ZOO."""
    from tq_tpu_torch.evals.compare import compare_file

    ref_path = ROOT / "results" / out_file.name
    got = json.loads(out_file.read_text())
    ref = json.loads(ref_path.read_text())
    for key in ref:
        for col in ("tmacs", "avg_terms", "params"):
            if got[key][col] != ref[key][col]:
                fail(f"{arch} sweep {key} {col}: {got[key][col]} != "
                     f"{ref_path.name}'s {ref[key][col]}")
    lines = compare_file(out_file, ref_path)
    bad = [ln for ln in lines if any(w in ln for w in
                                     ("MISMATCH", "LENGTH", "missing"))]
    if bad:
        fail(f"{arch} sweep: the compare finds {bad}")
    if arch == "alexnet":
        cols = {k: {c: v[c] for c in ("tmacs", "avg_terms", "params")}
                for k, v in got.items()}
        if cols != EXPECTED_ZOO["alexnet"]["columns"]:
            fail("alexnet sweep columns differ from the JAX package's")


def _sweep_scales_hold(torch, arch: str, calibrated) -> dict:
    """The sweep's (9, 8, 12, 9, 3) scales equal the JAX package's, or are
    near-ties by the MSE search's own objective; returns the near-ties."""
    exp = EXPECTED_ZOO[arch]["sweep_sf"]
    wb, gs, wt, db, dt = exp["setting"]
    match = [st for qcfg, st in calibrated if all(
        (t.weight_bits, t.group_size, t.weight_terms, t.data_bits,
         t.data_terms) in ((wb, gs, wt, db, dt), (16, 1, 16, db, dt))
        for t in qcfg.values()) and any(
            t.weight_bits == wb for t in qcfg.values())]
    if len(match) != 1:
        fail(f"{arch}: setting {exp['setting']} calibrated {len(match)} "
             "times")
    if len(match[0]) != len(exp["sf"]):
        fail(f"{arch}: {len(match[0])} calibrated layers, the JAX package "
             f"{len(exp['sf'])}")
    near_ties = {}
    for (name, st), want in zip(match[0].items(), exp["sf"]):
        have = float(st["sf"])
        if have != want:
            ea, eb = (_mse_at(torch, st["hist"], v, db, dt)
                      for v in (have, want))
            if abs(ea - eb) > 1e-6 * max(ea, eb):
                fail(f"{arch} sweep {name}: calibrated sf {have} != the JAX "
                     f"package's {want} (errors {ea}, {eb})")
            near_ties[name] = dict(card=have, jax=want, err_card=ea,
                                   err_jax=eb)
    return near_ties


def phase_cnn_zoo(torch, tmp: Path):
    """VGG-16-bn, MobileNet-v2, EfficientNet-b0 and AlexNet at 224x224 on
    zoo_params' weights, through the port's entry points: the pinned
    program (ZOO_PROGRAM) and its bf16 serving mode, then ``run_sweep``
    over the arch's published grid on 64 synthetic images at batch 64, and
    int8 serving (UQ packed by ``pack_cnn``, every sf 0.05) in float32 and
    bfloat16 at the program's batch; the launches of each arch's run
    counted from 0.  Then, uncounted: the program's logits against the JAX
    package's (EXPECTED_ZOO), each conv card against CPU on the same
    input, the boundary flips, the bf16 mode within the JAX test's class,
    the sweep's columns against ``results/`` and its scales against the
    JAX package's, the int8 forms (``_int8_held``); images/s of every
    form at batch 64.  Returns (launches, B1's int32-output cells at each
    arch's first int8 conv)."""
    from tq_tpu_torch.convert import (convert_cnn, make_cnn_apply, pack_cnn,
                                      static_conv_layer_settings)
    from tq_tpu_torch.data.imagenet import find_imagenet_val
    from tq_tpu_torch.evals import cnn as cnn_eval

    if find_imagenet_val() is not None:
        fail("EXPECTED_ZOO holds the synthetic batches' numbers; unset "
             "TQ_DATA_DIR")
    f = ZOO_PROGRAM
    x_np = np.random.default_rng(0).normal(
        size=(f["batch"], f["image"], f["image"], 3)).astype(np.float32)
    finalize = cnn_eval.finalize_cnn
    total: dict = {}
    int8_cells: dict = {}
    results = {}
    misses: list = []  # against the JAX package: reported after every arch
    t_phase = time.perf_counter()
    for arch in ZOO_ARCHS:
        ckpt = tmp / f"{arch}.npz"
        zoo_checkpoint(arch, ckpt)
        m = cnn_eval.get_model(arch)
        settings = static_conv_layer_settings(m.conv_specs(), *f["tr"])
        calibrated = []

        def capture(qstate, qcfg):  # the scales each setting calibrates
            out = finalize(qstate, qcfg)
            calibrated.append((qcfg, out))
            return out

        out_file = tmp / f"{arch}-results.json"
        _reset_counts()
        t0 = time.perf_counter()
        _, params = cnn_eval.load_params(arch, str(ckpt), device="cuda")
        qp, qc, qs = convert_cnn(m, params, settings, f["db"], f["dt"])
        qs = _with_sf(torch, qs, f["sf"])
        x = torch.as_tensor(x_np, device="cuda")
        logits, _ = make_cnn_apply(m, qc, track=False)(qp, qs, x)
        logits_bf16, _ = make_cnn_apply(m, qc, track=False,
                                        compute_dtype=torch.bfloat16)(
            qp, qs, x)
        torch.cuda.synchronize()
        program_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        uqp, uqc, uqs = convert_cnn(
            m, params, static_conv_layer_settings(m.conv_specs(),
                                                  *INT8_UQ[0]),
            *INT8_UQ[1])
        uqs = _with_sf(torch, uqs, f["sf"])
        packed = pack_cnn(uqp, uqc)
        int8_fwd = make_cnn_apply(m, uqc, track=False)
        int8_bf16_fwd = make_cnn_apply(m, uqc, track=False,
                                       compute_dtype=torch.bfloat16)
        int8_fwd(packed, uqs, x)
        int8_bf16_fwd(packed, uqs, x)
        torch.cuda.synchronize()
        int8_s = time.perf_counter() - t0
        cnn_eval.finalize_cnn = capture
        try:
            t0 = time.perf_counter()
            sweep = cnn_eval.run_sweep(arch, checkpoint=str(ckpt),
                                       out_file=str(out_file), batch_size=64,
                                       n_synth=64, verbose=False,
                                       device="cuda",
                                       **cnn_eval.PUBLISHED_GRIDS[arch])
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
        finally:
            cnn_eval.finalize_cnn = finalize
        launches = _read_counts()
        _require_launched(launches, ["tr_quantize_elementwise",
                                     "tr_quantize_elementwise_bf16",
                                     "tr_quantize_elementwise_int",
                                     "tr_quantize_elementwise_bf16_int",
                                     "tr_quantize_grouped"], arch)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        t0 = time.perf_counter()
        for name, t in (("f32", logits), ("bf16", logits_bf16)):
            if t.shape != (f["batch"], 1000) or t.dtype != torch.float32 \
                    or not bool(torch.isfinite(t).all()):
                fail(f"{arch} {name}: logits of shape {tuple(t.shape)} and "
                     f"type {t.dtype}, or not finite")
        bf16_rel = float((logits_bf16 - logits).norm() / logits.norm())
        if bf16_rel >= 0.2:
            fail(f"{arch} bf16: {bf16_rel} (relative norm) from the float32 "
                 "mode")
        logits_g, lw = _zoo_layerwise(torch, m, settings, ckpt, qp, qc, qs,
                                      x, arch)
        if not torch.equal(logits_g, logits):
            fail(f"{arch}: the recorded forward differs from the model's")
        limit = ZOO_LOGIT_RTOL[arch]
        jax_err, jax_misses = _vs_jax(torch, logits,
                                      EXPECTED_ZOO[arch]["program"], limit)
        misses += [f"{arch}: {m}" for m in jax_misses]
        _sweep_columns_hold(arch, out_file)
        near_ties = _sweep_scales_hold(torch, arch, calibrated)
        int8, cells = _int8_held(torch, m, uqp, packed, uqc, uqs, x, limit,
                                 arch, timed=True,
                                 flip_limit=ZOO_FLIP_RTOL[arch])
        for row, c in cells.items():
            int8_cells.setdefault(row, {}).update(c)
        check_s = time.perf_counter() - t0
        # A forward's throughput at batch 64: unquantized, TR f32, TR bf16
        # (the depthwise convs stay cuDNN float32 convs with groups).
        x64 = torch.randn(64, f["image"], f["image"], 3, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
        f32_fwd = make_cnn_apply(m, qc, track=False)
        bf16_fwd = make_cnn_apply(m, qc, track=False,
                                  compute_dtype=torch.bfloat16)
        images_per_s = {
            "fp32_unquantized": _images_per_s(
                torch, lambda: m.apply(params, x64), 64),
            "tr_f32": _images_per_s(torch, lambda: f32_fwd(qp, qs, x64), 64),
            "tr_bf16": _images_per_s(torch, lambda: bf16_fwd(qp, qs, x64),
                                     64),
            "uq_int8": _images_per_s(
                torch, lambda: int8_fwd(packed, uqs, x64), 64),
            "uq_int8_bf16": _images_per_s(
                torch, lambda: int8_bf16_fwd(packed, uqs, x64), 64)}
        del x64
        results[arch] = dict(
            program_seconds=program_s, int8_seconds=int8_s,
            sweep_seconds=sweep_s,
            settings=sum(len(v["accs"]) for v in sweep.values()),
            check_seconds=check_s, launches=launches,
            logit_stat_max_rel_err_vs_jax=jax_err, limit=limit,
            top1=logits.argmax(1).tolist(), bf16_vs_f32_rel_norm=bf16_rel,
            sf_equal=len(EXPECTED_ZOO[arch]["sweep_sf"]["sf"])
            - len(near_ties), sf_near_ties=near_ties,
            images_per_s_batch64=images_per_s, int8=int8, **lw)
        del qp, qs, params, logits, logits_bf16, logits_g, uqp, packed
        torch.cuda.empty_cache()
        ckpt.unlink()  # VGG's is 553 MB
    t0 = time.perf_counter()
    list(cnn_eval._batches("vgg16_bn", None, 64, 64))
    emit({"phase": "cnn_zoo", "ok": not misses,
          "seconds": time.perf_counter() - t_phase,
          "data_seconds_per_setting": time.perf_counter() - t0,
          "batch": f["batch"], "image": f["image"], "results": results})
    if misses:
        fail(f"cnn_zoo: {misses}")
    return total, int8_cells


# --------------------------------------------------------------- phase 15


def phase_group_size(torch, ckpt: Path, tmp: Path):
    """``evals/group_size.py``'s ``run_grid('resnet18')`` over all 25 (g,
    alpha) settings on 64 synthetic images at batch 64, one group size a
    call (the counts read after each): tmacs and avg_terms equal to
    ``results/resnet18-group-size-results.json``; B2 launched at every
    g > 1 (g = 2 and 32 on its generic instantiation), never at g = 1."""
    from tq_tpu_torch.evals.compare import compare_file
    from tq_tpu_torch.evals.group_size import GROUP_SIZES, run_grid

    ref_path = ROOT / "results" / "resnet18-group-size-results.json"
    out_file = tmp / ref_path.name
    total: dict = {}
    by_g, seconds = {}, {}
    t_phase = time.perf_counter()
    for g in GROUP_SIZES:
        _reset_counts()
        t0 = time.perf_counter()
        got = run_grid("resnet18", checkpoint=str(ckpt),
                       out_file=str(out_file), batch_size=64, n_synth=64,
                       group_sizes=(g,), verbose=False, device="cuda")
        torch.cuda.synchronize()
        seconds[g] = time.perf_counter() - t0
        launches = _read_counts()
        by_g[g] = {k: launches[k] for k in ("tr_quantize_elementwise",
                                            "tr_quantize_grouped")}
        if (launches["tr_quantize_grouped"] > 0) != (g > 1):
            fail(f"group-size grid g={g}: {launches['tr_quantize_grouped']} "
                 "launches of the grouped body")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    published = json.loads(ref_path.read_text())
    for key, cols in published.items():
        for col in ("tmacs", "avg_terms"):
            if got[key][col] != cols[col]:
                fail(f"group-size grid g={key} {col}: {got[key][col]} != "
                     f"published {cols[col]}")
    lines = compare_file(out_file, ref_path)
    if any("MISMATCH" in ln or "LENGTH" in ln or "missing" in ln
           for ln in lines):
        fail(f"group-size grid: the compare finds {lines}")
    _require_launched(total, ["tr_quantize_elementwise",
                              "tr_quantize_grouped", "histogram"],
                      "group-size grid")
    emit({"phase": "group_size", "ok": True,
          "seconds": time.perf_counter() - t_phase,
          "settings": sum(len(v["accs"]) for v in got.values()),
          "seconds_by_g": seconds, "launches_by_g": by_g,
          "launches": total, "accs": {k: v["accs"] for k, v in got.items()}})
    return total


# --------------------------------------------------------------- phase 16


# The Transformer's converted weights, stored (in, out): out_proj, linear1
# and linear2 of each layer, and the decoder read in place (its own
# weight, not the encoder's transpose).
TFM_WEIGHTS = [(650, 650), (650, VOCAB)]
# The streaming kernel's variants on the Transformer's serving path.
TFM_STREAM_ROWS = ("term_matmul_raw_packed8", "term_matmul_raw_int16",
                   "term_matmul_raw_int8")
# TR serving generation of the Transformer (raw input, no fixed decoder):
# (name, (wb, gs, wt, db, dt), pack).
TFM_GEN_CONFIGS = [
    ("u8s", (8, 8, 24, 8, 8), "u8s"),
    ("int16", (8, 8, 24, 8, 8), "int"),
    ("int8", (7, 8, 12, 7, 3), "int"),
]


def phase_tfm_kernels(torch):
    """B1, B2 and the streaming ``term_matmul`` at the Transformer's
    shapes, against the plain versions first, then timed: B1 (g = 1, bits
    5 and 9, as many terms) and B2 (g = 8, axis 0, bits 8, 24 terms, read
    in place; B5 on as many elements) bit for bit on TFM_WEIGHTS; the
    streaming kernel at (1, 650, 650) and (1, 650, 33278) in the three
    raw-input variants within rtol 1e-5, atol 1e-4 * max|ref|, warm and
    cold beside ``torch.matmul`` on the float32 weights."""
    from tq_tpu_torch.kernels.term_matmul import (VARIANTS, term_matmul,
                                                  term_matmul_ref)
    from tq_tpu_torch.kernels.tr_quantize import (tr_quantize,
                                                  tr_quantize_ref,
                                                  tr_scale_copy)
    from tq_tpu_torch.layers.common import weight_scale

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {"tr_quantize_elementwise": {}, "tr_quantize_grouped": {}}
    cases = 0
    for K, N in TFM_WEIGHTS:
        w = (torch.rand(K, N, generator=gen, device=dev) * 2 - 1) / K ** 0.5
        key = f"{K}x{N}"
        for bits in (5, 9):
            wsf = weight_scale(w, bits)
            _exact(torch, f"tfm B1 {key} bits={bits}",
                   tr_quantize(w, wsf, bits, 1, bits),
                   tr_quantize_ref(w, wsf, bits, 1, bits))
            cases += 1
            rows["tr_quantize_elementwise"][f"{key}_bits{bits}"] = dict(
                bits=bits, terms=bits, **_cell(
                    torch, lambda: tr_quantize(w, wsf, bits, 1, bits),
                    lambda: tr_quantize_ref(w, wsf, bits, 1, bits),
                    8 * w.numel(), w.numel(), big=N == VOCAB))
        wsf = weight_scale(w, 8)
        _exact(torch, f"tfm B2 {key} g=8", tr_quantize(w, wsf, 8, 8, 24, 0),
               tr_quantize_ref(w, wsf, 8, 8, 24, 0))
        cases += 1
        rows["tr_quantize_grouped"][f"{key}_g8"] = dict(
            group_size=8, bits=8, terms=24, **_cell(
                torch, lambda: tr_quantize(w, wsf, 8, 8, 24, 0),
                lambda: tr_quantize_ref(w, wsf, 8, 8, 24, 0), 8 * w.numel(),
                w.numel(), big=N == VOCAB),
            copy_ceiling_ms=device_ms(torch, lambda: tr_scale_copy(w, wsf)))
    max_err = {}
    for row in TFM_STREAM_ROWS:
        variant = TERM_MATMUL_ROWS[row]
        mode, fmt, quantize_x = VARIANTS[variant]
        cells = rows.setdefault(row, {})
        for K, N in TFM_WEIGHTS:
            weight = _tm_weights(torch, fmt, K, N, gen, dev)
            w, w_sf, _ = weight
            x = torch.randn(1, K, generator=gen, device=dev)
            kw = dict(w_sf=w_sf, quantize_x=False)
            before = term_matmul.kernel_launches["stream"]
            out = term_matmul(x, w, 1.0, **kw)
            ref = term_matmul_ref(x, w, 1.0, **kw)
            torch.cuda.synchronize()
            if term_matmul.kernel_launches["stream"] != before + 1:
                fail(f"term_matmul {variant} (1, {K}, {N}) did not take the "
                     "streaming kernel")
            err, scale = float((out - ref).abs().max()), float(
                ref.abs().max())
            if not torch.allclose(out, ref, rtol=1e-5, atol=1e-4 * scale):
                fail(f"term_matmul {variant} (1, {K}, {N}): max |diff| {err} "
                     f"(max |ref| {scale})")
            max_err[row] = max(max_err.get(row, 0.0), err)
            cases += 1
            cells[f"1x{K}x{N}"] = dict(max_abs_err=err, **_serving_row_times(
                torch, variant, weight, x))
            del weight, w
    emit({"phase": "tfm_kernels", "ok": True, "cases": cases,
          "max_abs_err": max_err, "results": rows})
    return rows


def phase_tfm_sweep(torch, ckpt: Path):
    """``run_sweep(model="Transformer")`` on the card over
    EXPECTED_TFM_SWEEPS' settings: tmacs and param_bits equal, ppl within
    rtol 1e-3; B1 and B2 launched."""
    from tq_tpu_torch.data.wikitext import load_corpus
    from tq_tpu_torch.evals.lstm import run_sweep

    if load_corpus()[1] != "synthetic":
        fail("EXPECTED_TFM_SWEEPS hold the synthetic test stream's numbers; "
             "unset TQ_DATA_DIR")
    _reset_counts()
    t0 = time.perf_counter()
    got, setting_seconds = {}, {}
    for name, exp in EXPECTED_TFM_SWEEPS.items():
        s = exp["settings"]
        t1 = time.perf_counter()
        got[name] = run_sweep(s["wb"], s["wt"], s["db"], s["dt"], s["gs"],
                              checkpoint=str(ckpt), verbose=False,
                              model="Transformer", device="cuda")
        torch.cuda.synchronize()
        setting_seconds[name] = ((time.perf_counter() - t1)
                                 / len(exp["ppls"]))
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    gap = 0.0
    for name, exp in EXPECTED_TFM_SWEEPS.items():
        for key in ("tmacs", "param_bits"):
            if got[name][key] != [float(v) for v in exp[key]]:
                fail(f"Transformer {name} {key}: {got[name][key]} != JAX "
                     f"{exp[key]}")
        for a, b in zip(got[name]["ppls"], exp["ppls"]):
            gap = max(gap, abs(a - b) / abs(b))
    if gap > 1e-3:
        fail(f"Transformer sweep ppl differs from the JAX package's by {gap} "
             "(relative)")
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_grouped", "histogram"],
                      "Transformer sweep")
    emit({"phase": "tfm_sweep", "ok": True, "seconds": seconds,
          "seconds_per_setting": setting_seconds,
          "settings": sum(len(e["ppls"]) for e in
                          EXPECTED_TFM_SWEEPS.values()),
          "ppl_max_rel_gap": gap, "launches": launches, "results": got})
    return launches


def _tokens_per_s(torch, sample) -> float:
    """``sample(words)`` after a 5-token warm-up: GEN_WORDS / seconds."""
    sample(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample(GEN_WORDS)
    return GEN_WORDS / (time.perf_counter() - t0)


def _decode_run(torch, params, tokens, device, qcfg=None, qstate=None):
    """Teacher-forced KV-cache decoding over ``tokens`` on ``device``:
    the (len, vocab) log-probs, and the cache at the end."""
    from tq_tpu_torch.models import transformer_lm

    d = params["encoder"]["w"].shape[1]
    nlayers = sum(1 for k in params if k.endswith(".linear1"))
    cache = transformer_lm.decode_init_cache(len(tokens), 1, d, TFM_NHEAD,
                                             nlayers, device=device)
    rows = []
    for pos, t in enumerate(tokens):
        logp, cache = transformer_lm.decode_step(
            params, torch.tensor([[t]], device=device), pos, cache,
            nhead=TFM_NHEAD, qcfg=qcfg, qstate=qstate)
        rows.append(logp)
    return torch.cat(rows), cache


def _converted_equal(a, b, names) -> bool:
    from tq_tpu_torch.utils.checkpoint import flatten_tree

    fa = flatten_tree({n: a[n] for n in names})
    fb = flatten_tree({n: b[n] for n in names})
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


def phase_tfm_generation(torch, ckpt: Path, card: str, smi: str):
    """The Transformer's serving paths at full width: the fp32 sampler
    (``generate_transformer``, the full prefix every token) and the TR
    sampler (``generate_transformer_tr``, a KV-cache step a token) in each
    of TFM_GEN_CONFIGS, 100 tokens each, every raw-input streaming variant
    launched; then each serving model on the card and on the CPU from the
    card's converted weights (equal scales and packs, teacher-forced
    log-probs over 16 sampled tokens within atol 1e-4), ``decode_step``
    against the full-prefix forward on the card at every one of the 16
    positions (1e-5 fp32, 2e-4 packed), and tokens/s of each sampler.
    Returns (launches, the u8s model and its tokens for phase 18)."""
    from tq_tpu_torch.evals.generate import (calibrate_transformer,
                                             generate_transformer,
                                             generate_transformer_tr,
                                             sample_transformer)
    from tq_tpu_torch.models import transformer_lm
    from tq_tpu_torch.utils.params import params_from_jax

    params_np, stream = _lstm_inputs(ckpt)
    params = params_from_jax(params_np, "cuda")
    _reset_counts()
    t0 = time.perf_counter()
    tokens, seconds = {}, {}
    t1 = time.perf_counter()
    tokens["fp32"] = generate_transformer(params, VOCAB, GEN_WORDS,
                                          seed=GEN_SEED, nhead=TFM_NHEAD,
                                          device="cuda")
    seconds["fp32"] = time.perf_counter() - t1
    for name, tr, pack in TFM_GEN_CONFIGS:
        t1 = time.perf_counter()
        tokens[name] = generate_transformer_tr(
            params, VOCAB, GEN_WORDS, seed=GEN_SEED, nhead=TFM_NHEAD, tr=tr,
            pack_fmt=pack, calib_stream=stream, device="cuda")
        seconds[name] = time.perf_counter() - t1
    for name, toks in tokens.items():
        if len(toks) != GEN_WORDS or not all(0 <= t < VOCAB for t in toks):
            fail(f"Transformer generation {name}: tokens out of range or "
                 "missing")
    generation_seconds = time.perf_counter() - t0
    launches = _read_counts()
    _require_launched(launches, ["tr_quantize_grouped", *TFM_STREAM_ROWS,
                                 "term_matmul_kernel_stream"],
                      "Transformer generation")

    # fp32: the KV-cache step against the full prefix, and tokens/s.
    toks = tokens["fp32"][:TEACHER_TOKENS]
    full = transformer_lm.apply(params, torch.tensor(toks, device="cuda")[
        :, None], nhead=TFM_NHEAD)
    inc, _ = _decode_run(torch, params, toks, "cuda")
    fp32_gap = float((inc - full).abs().max())
    if fp32_gap > 1e-5:
        fail(f"Transformer fp32 decode_step differs from the full prefix by "
             f"{fp32_gap}")
    results = {"fp32": dict(decode_vs_full_prefix=fp32_gap,
                            tokens_per_s=_tokens_per_s(
                                torch, lambda n: generate_transformer(
                                    params, VOCAB, n, seed=GEN_SEED,
                                    nhead=TFM_NHEAD, device="cuda")))}
    served = {}
    groups: dict = {}
    for name, tr, pack in TFM_GEN_CONFIGS:
        groups.setdefault(tr, []).append((name, pack))
    for tr, packs in groups.items():
        qp, qc, qs0 = transformer_lm.convert(params, *tr)
        qs = calibrate_transformer(qp, qc, qs0, stream, nhead=TFM_NHEAD)
        # The CPU path starts from the card's converted weights (the
        # conversion kernels are bit-exact: phase tfm_kernels).
        qp_c = params_from_jax(qp, "cpu")
        qs_c = calibrate_transformer(qp_c, qc, params_from_jax(qs0, "cpu"),
                                     stream, nhead=TFM_NHEAD)
        for n in qc:
            if float(qs[n]["sf"]) != float(qs_c[n]["sf"]):
                fail(f"Transformer serving {tr}: calibrated {n} sf "
                     f"{float(qs[n]['sf'])} (card) != {float(qs_c[n]['sf'])} "
                     "(cpu)")
        for name, pack in packs:
            qpk = transformer_lm.pack(qp, qc, fmt=pack)
            qpk_c = transformer_lm.pack(qp_c, qc, fmt=pack)
            if not _converted_equal(qpk, qpk_c, list(qc)):
                fail(f"Transformer serving {name}: packed weights differ card "
                     "vs cpu")
            toks = tokens[name][:TEACHER_TOKENS]
            inc, _ = _decode_run(torch, qpk, toks, "cuda", qc, qs)
            inc_c, _ = _decode_run(torch, qpk_c, toks, "cpu", qc, qs_c)
            qfull, _ = transformer_lm.make_quantized_apply(
                qc, track=False, nhead=TFM_NHEAD)(
                    qp, qs, torch.tensor(toks, device="cuda")[:, None])
            cpu_gap = float((inc.cpu() - inc_c).abs().max())
            full_gap = float((inc - qfull).abs().max())
            if cpu_gap > 1e-4:
                fail(f"Transformer serving {name}: teacher-forced log-probs "
                     f"differ by {cpu_gap} card vs cpu")
            if full_gap > 2e-4:
                fail(f"Transformer serving {name}: decode_step differs from "
                     f"the full prefix by {full_gap}")
            results[name] = dict(
                tr=list(tr), pack=pack,
                sf={n: float(qs[n]["sf"]) for n in qc},
                logp_max_abs_err_cpu=cpu_gap, decode_vs_full_prefix=full_gap,
                tokens_per_s=_tokens_per_s(
                    torch, lambda n, qpk=qpk: sample_transformer(
                        qpk, qc, qs, VOCAB, n, seed=GEN_SEED,
                        nhead=TFM_NHEAD)))
            if name == "u8s":
                served = dict(qparams=qpk, qcfg=qc, qstate=qs,
                              tokens=tokens[name])
    emit({"phase": "tfm_generation", "ok": True, "card": card,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t0,
          "generation_seconds": generation_seconds,
          "config_seconds": seconds, "words": GEN_WORDS,
          "teacher_tokens": TEACHER_TOKENS, "launches": launches,
          "first_tokens": {k: v[:8] for k, v in tokens.items()},
          "results": results})
    return launches, served


def _reloaded_steps(torch, direct, loaded, inputs, carry):
    """Run ``direct`` and ``loaded`` side by side over ``inputs`` from
    the same carry; returns (max |diff| of the log-probs and of the carry,
    streaming and B1 launches inside the loaded program)."""
    from tq_tpu_torch.kernels.term_matmul import term_matmul
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize

    logp_err = carry_err = 0.0
    launches = {"term_matmul_kernel_stream": 0, "tr_quantize_elementwise": 0}
    cd = ce = carry
    for args in inputs:
        ld, cd = direct(*args, cd)
        s0 = term_matmul.kernel_launches["stream"]
        e0 = tr_quantize.launches["elementwise"]
        le, ce = loaded(*args, ce)
        torch.cuda.synchronize()
        launches["term_matmul_kernel_stream"] += (
            term_matmul.kernel_launches["stream"] - s0)
        launches["tr_quantize_elementwise"] += (
            tr_quantize.launches["elementwise"] - e0)
        logp_err = max(logp_err, float((ld - le).abs().max()))
        flat_d = list(cd.values()) if isinstance(cd, dict) else list(cd)
        flat_e = list(ce.values()) if isinstance(ce, dict) else list(ce)
        carry_err = max([carry_err] + [float((a - b).abs().max())
                                       for a, b in zip(flat_d, flat_e)])
    return logp_err, carry_err, launches


def _step_ms(torch, step, inputs, carry) -> float:
    """Host ms a step of ``step`` over ``inputs`` from ``carry``, ending
    in a synchronize (after one warm-up pass)."""
    def run():
        c = carry
        for args in inputs:
            _, c = step(*args, c)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) * 1e3 / len(inputs)


# Steps of the portable artifacts loaded on the CPU, held against the CPU
# direct step (the plain versions at full width: about 0.1 s a step).
PORTABLE_CPU_STEPS = 4


def _portable(torch, export, direct, direct_cpu, inputs, carry) -> dict:
    """One step exported on the CPU as a portable artifact (``export(
    platforms)``), loaded on the card, run beside the card's direct step
    over ``inputs`` from ``carry`` (no plain version on the card), then
    loaded on the CPU and run beside the CPU's direct step over the first
    PORTABLE_CPU_STEPS inputs; the export's seconds, host ms a step of
    the loaded program on the card."""
    from tq_tpu_torch.utils.export import (load_serving, serving_platforms,
                                           to_cpu)

    platforms = ("cpu", "cuda")
    t0 = time.perf_counter()
    data = export(platforms)
    export_s = time.perf_counter() - t0
    if serving_platforms(data) != platforms:
        fail(f"portable artifact: platforms {serving_platforms(data)}")
    loaded = load_serving(data)  # the card: the default of a portable one
    with _NoPlainOnCard():
        r = dict(zip(("logp_max_abs_err", "cache_max_abs_err",
                      "loaded_launches"),
                     _reloaded_steps(torch, direct, loaded, inputs, carry)))
        r["step_ms_loaded"] = _step_ms(torch, loaded, inputs, carry)
    cpu = dict(zip(("logp_max_abs_err", "cache_max_abs_err"),
                   _reloaded_steps(torch, direct_cpu,
                                   load_serving(data, device="cpu"),
                                   to_cpu(inputs[:PORTABLE_CPU_STEPS]),
                                   to_cpu(carry))))
    return dict(r, cpu=dict(cpu, steps=PORTABLE_CPU_STEPS),
                export_seconds_cpu=export_s, bytes=len(data),
                platforms=list(platforms))


def phase_tfm_export(torch, served: dict, lstm_ckpt: Path, stream):
    """The serving steps as ``torch.export`` programs on the card: the
    Transformer's u8s ``decode_step`` at cache length GEN_WORDS + 1 and the
    LSTM's u8s step (``export_lm_step``), each saved, reloaded and run
    beside the direct step over 16 steps: the same log-probs and carry,
    bit for bit or within 1e-6, and the streaming kernel launched inside
    the loaded program (and B1, the LSTM's activation quantizer); host ms
    a step of each.  Then each as a portable artifact (``_portable``):
    traced on the CPU for ("cpu", "cuda"), held the same way on the card
    and against the CPU direct step on the CPU."""
    from tq_tpu_torch.evals.generate import (export_transformer_step,
                                             serving_model)
    from tq_tpu_torch.models import lstm_lm, transformer_lm
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.export import (export_lm_step, load_serving,
                                           to_cpu)
    from tq_tpu_torch.utils.params import params_from_jax

    results = {}
    qp, qc, qs = served["qparams"], served["qcfg"], served["qstate"]
    L = GEN_WORDS + 1
    t0 = time.perf_counter()
    data = export_transformer_step(qp, qc, qs, L, nhead=TFM_NHEAD)
    export_s = time.perf_counter() - t0
    loaded = load_serving(data)
    cache0 = transformer_lm.decode_init_cache(
        L, 1, qp["encoder"]["w"].shape[1], TFM_NHEAD,
        sum(1 for k in qp if k.endswith(".linear1")), device="cuda")

    def direct(tok, pos, cache):
        return transformer_lm.decode_step(qp, tok, pos, cache,
                                          nhead=TFM_NHEAD, qcfg=qc,
                                          qstate=qs)

    inputs = [(torch.tensor([[t]], device="cuda"),
               torch.tensor(pos, device="cuda"))
              for pos, t in enumerate(served["tokens"][:TEACHER_TOKENS])]
    results["transformer_u8s"] = dict(zip(
        ("logp_max_abs_err", "cache_max_abs_err", "loaded_launches"),
        _reloaded_steps(torch, direct, loaded, inputs, cache0)),
        export_seconds=export_s, bytes=len(data), cache_length=L,
        step_ms_direct=_step_ms(torch, direct, inputs, cache0),
        step_ms_loaded=_step_ms(torch, loaded, inputs, cache0))
    qp_c, qs_c = to_cpu(qp), to_cpu(qs)

    def direct_cpu(tok, pos, cache):
        return transformer_lm.decode_step(qp_c, tok, pos, cache,
                                          nhead=TFM_NHEAD, qcfg=qc,
                                          qstate=qs_c)

    results["transformer_u8s_portable"] = _portable(
        torch, lambda platforms: export_transformer_step(
            qp, qc, qs, L, nhead=TFM_NHEAD, platforms=platforms),
        direct, direct_cpu, inputs, cache0)

    lstm = params_from_jax(load_params(lstm_ckpt), "cuda")
    lqp, lqc, lqs = serving_model(lstm, (8, 8, 24, 8, 8), "u8s", stream)
    t0 = time.perf_counter()
    data = export_lm_step(lqp, lqc, lqs)
    export_s = time.perf_counter() - t0
    loaded = load_serving(data)
    fwd = lstm_lm.make_quantized_apply(lqc, track=False)

    def lstm_direct(tok, hidden):
        logp, hidden, _ = fwd(lqp, lqs, tok, hidden)
        return logp, hidden

    toks = np.random.default_rng(GEN_SEED).integers(0, VOCAB, TEACHER_TOKENS)
    inputs = [(torch.tensor([[int(t)]], device="cuda"),) for t in toks]
    hidden0 = lstm_lm.init_hidden(1, nhid=lqp["rnn"][0]["b_hh"].shape[0] // 4,
                                  nlayers=len(lqp["rnn"]), device="cuda")
    results["lstm_u8s"] = dict(zip(
        ("logp_max_abs_err", "cache_max_abs_err", "loaded_launches"),
        _reloaded_steps(torch, lstm_direct, loaded, inputs, hidden0)),
        export_seconds=export_s, bytes=len(data),
        step_ms_direct=_step_ms(torch, lstm_direct, inputs, hidden0),
        step_ms_loaded=_step_ms(torch, loaded, inputs, hidden0))
    lqp_c, lqs_c = to_cpu(lqp), to_cpu(lqs)

    def lstm_direct_cpu(tok, hidden):
        logp, hidden, _ = fwd(lqp_c, lqs_c, tok, hidden)
        return logp, hidden

    results["lstm_u8s_portable"] = _portable(
        torch, lambda platforms: export_lm_step(lqp, lqc, lqs,
                                                platforms=platforms),
        lstm_direct, lstm_direct_cpu, inputs, hidden0)
    for name, r in results.items():
        for where, rr in (("card", r), ("cpu", r.get("cpu"))):
            if rr is None:
                continue
            worst = max(rr["logp_max_abs_err"], rr["cache_max_abs_err"])
            if worst > 1e-6:
                fail(f"exported {name} step loaded on the {where} differs "
                     f"from the direct step by {worst}")
            rr["bit_exact"] = worst == 0.0
        if r["loaded_launches"]["term_matmul_kernel_stream"] <= 0:
            fail(f"exported {name} step: the loaded program launched no "
                 "streaming term_matmul kernel")
    for name in ("lstm_u8s", "lstm_u8s_portable"):
        if results[name]["loaded_launches"]["tr_quantize_elementwise"] <= 0:
            fail(f"exported {name} step: the loaded program launched no "
                 "tr_quantize")
    emit({"phase": "tfm_export", "ok": True, "steps": TEACHER_TOKENS,
          "results": results})


# ------------------------------------------------------------- train group

# term_reveal_st's shapes on the train path: (name, shape, bits, g, terms):
# QAT's weights at its two settings (axis 0) and a dense input (g = 1).
TRAIN_ST_CASES = [("784x512_g1_bits1", (784, 512), 1, 1, 1),
                  ("784x512_g8_bits4", (784, 512), 4, 8, 6),
                  ("64x784_act_bits6", (64, 784), 6, 1, 6)]
LM_SHORT_TOKENS = 140000  # the dropout-0.2 runs at full width: 199 chunks
# GRU, RNN_TANH and RNN_RELU: one epoch of 99 chunks at width 200 and lr 5.
# At the recipe's lr 20 one epoch at this width does not improve on the
# init (the whole stream on an H100: GRU 10.88 against 10.41, RNN_TANH
# 13.17, RNN_RELU NaN; at lr 5 all three reach 7.77-7.84); the JAX
# package's own training tests use lr 5 on their small models too.
LM_SMALL_WIDTH, LM_SMALL_TOKENS, LM_SMALL_LR = 200, 70000, 5.0


# Gradients card against CPU, relative in norm.  A ReLU's gradient jumps
# at its kink, and float32 sum order can put a pre-activation within noise
# of 0 on the other side (found on the card at batch 64: the fc2 gradient
# off by 14% of its largest in one column) while the loss, continuous
# there, stays within 1e-6.
GRAD_NORM_RTOL = 5e-2


def _norm_gap(got, want) -> float:
    return float((got.cpu() - want).norm() / want.norm())


def _rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want), initial=0.0))


def _qat_input_codes(torch, params, x, setting):
    """Per layer of ``qat_apply(..., act_quant=True)``: the integer codes
    of its term-revealed input (its values over its scale; the scale is
    max|input| / 2^(db-1), which an ulp of sum order in the largest input
    moves by an ulp)."""
    from tq_tpu_torch.evals.qat_mlp import _st_scale
    from tq_tpu_torch.models.mlp import LAYER_NAMES
    from tq_tpu_torch.ops.term_reveal import term_reveal_st

    wb, gs, wt, db, dt = setting
    out = []
    with torch.no_grad():
        h = x.reshape(x.shape[0], -1)
        for i, name in enumerate(LAYER_NAMES):
            p = params[name]
            wq = term_reveal_st(p["w"], _st_scale(p["w"], wb), wb, gs, wt, 0)
            sf = _st_scale(h, db)
            h = term_reveal_st(h, sf, db, 1, dt, 0)
            out.append(torch.round(h / sf).to(torch.int32))
            h = torch.matmul(h, wq) + p["b"]
            if i < len(LAYER_NAMES) - 1:
                h = torch.relu(h)
    return out


def phase_st_kernels(torch, ckpt: Path):
    """``term_reveal_st`` on the card at TRAIN_ST_CASES: the forward bit for
    bit with ``tr_quantize_ref`` (one launch of B1 at g = 1, of B2 above),
    the backward the upstream gradient itself and a zero for sf, with no
    launch; timed (forward device and eager, forward plus backward eager)
    beside the B1/B2 rows.  Then ``qat_apply(..., act_quant=True)`` forward
    and backward on ``ckpt``'s weights and 512 samples, card against CPU:
    rows with a differing input code counted (at most 1%), the others'
    log-probs within atol 1e-4, the gradients within GRAD_NORM_RTOL in
    norm."""
    from tq_tpu_torch.evals.qat_mlp import _st_scale, qat_apply
    from tq_tpu_torch.evals.train_mlp import nll_loss, trainable
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize, tr_quantize_ref
    from tq_tpu_torch.models.mlp import LAYER_NAMES
    from tq_tpu_torch.ops.term_reveal import term_reveal_st
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = {"tr_quantize_elementwise": {}, "tr_quantize_grouped": {}}
    for name, shape, bits, g, terms in TRAIN_ST_CASES:
        x = torch.randn(shape, generator=gen, device=dev) / shape[0] ** 0.5
        sf = _st_scale(x, bits).requires_grad_(True)
        sfd = sf.detach()
        xg = x.clone().requires_grad_(True)
        up = torch.randn(shape, generator=gen, device=dev)
        row = "tr_quantize_elementwise" if g == 1 else "tr_quantize_grouped"
        before = _read_counts()
        y = term_reveal_st(xg, sf, bits, g, terms, 0)
        mid = _read_counts()
        gx, gsf = torch.autograd.grad(y, (xg, sf), up)
        after = _read_counts()
        _exact(torch, f"term_reveal_st {name}", y.detach(),
               tr_quantize_ref(x, sfd, bits, g, terms, 0))
        if not torch.equal(gx, up) or float(gsf) != 0.0:
            fail(f"term_reveal_st {name}: the backward is not (upstream "
                 f"gradient, 0) (sf gradient {float(gsf)})")
        if mid[row] != before[row] + 1 or after != mid:
            fail(f"term_reveal_st {name}: launches {before} -> {mid} -> "
                 f"{after}, not one {row} in the forward and none after")

        def fwd_bwd():
            torch.autograd.grad(term_reveal_st(xg, sfd, bits, g, terms, 0),
                                xg, up)

        rows[row][name] = dict(
            bits=bits, group_size=g, terms=terms, max_abs_err=0.0, **_cell(
                torch, lambda: term_reveal_st(x, sfd, bits, g, terms, 0),
                lambda: tr_quantize_ref(x, sfd, bits, g, terms, 0),
                8 * x.numel(), x.numel()),
            kernel_eager_ms=eager_ms(
                torch, lambda: tr_quantize(x, sfd, bits, g, terms, 0)),
            fwd_bwd_eager_ms=eager_ms(torch, fwd_bwd))

    # qat_apply with quantized activations, once, card against CPU.
    from tq_tpu_torch.data import load_mnist

    (xtr, ytr), _, _ = load_mnist()
    x, y = xtr[:512], ytr[:512]
    setting = QAT_SETTINGS["qat_1_1_1"]
    runs = {}
    for d in ("cuda", "cpu"):
        params = params_from_jax(load_params(ckpt), d)
        trainable(params)
        logp = qat_apply(params, torch.as_tensor(x, device=d), *setting,
                         act_quant=True)
        nll_loss(logp, torch.as_tensor(y, device=d)).backward()
        runs[d] = dict(logp=logp.detach().cpu(), grads={
            n: params[n]["w"].grad.cpu() for n in LAYER_NAMES},
            codes=[h.cpu() for h in _qat_input_codes(
                torch, params, torch.as_tensor(x, device=d), setting)])
    flipped = torch.zeros(len(y), dtype=torch.bool)
    for hg, hc in zip(runs["cuda"]["codes"], runs["cpu"]["codes"]):
        flipped |= (hg != hc).any(dim=1)
    n_flipped = int(flipped.sum())
    if n_flipped > len(y) // 100:
        fail(f"qat_apply act_quant: {n_flipped} of {len(y)} rows with a "
             "differing input code, more than sum-order flips explain")
    logp_err = float((runs["cuda"]["logp"] - runs["cpu"]["logp"])[
        ~flipped].abs().max())
    grad_err = max(_norm_gap(runs["cuda"]["grads"][n], runs["cpu"]["grads"][n])
                   for n in LAYER_NAMES)
    if logp_err > 1e-4 or grad_err > GRAD_NORM_RTOL:
        fail(f"qat_apply act_quant: log-probs differ by {logp_err}, "
             f"gradients by {grad_err} in norm")
    emit({"phase": "st_kernels", "ok": True, "cases": len(TRAIN_ST_CASES),
          "act_quant": dict(rows_with_boundary_flip=n_flipped,
                            logp_max_abs_err=logp_err,
                            grad_max_rel_err=grad_err),
          "results": rows})
    return rows


def _mnist_batches(steps: int):
    """``train``'s first ``steps`` batches of 64 (its default seed's
    permutation of the synthetic training set), as numpy arrays."""
    from tq_tpu_torch.data import load_mnist

    (xtr, ytr), _, source = load_mnist()
    if source != "synthetic":
        fail("EXPECTED_TRAIN holds the synthetic training set's numbers; "
             "unset TQ_DATA_DIR")
    perm = np.random.default_rng(TRAIN_ORDER_SEED).permutation(len(ytr))
    return [(xtr[perm[i * 64:(i + 1) * 64]], ytr[perm[i * 64:(i + 1) * 64]])
            for i in range(steps)]


def phase_mlp_train(torch, ckpt: Path):
    """The MLP trainer's step (Adadelta, dropout 0) over ``train``'s first
    TRAIN_STEPS batches from ``ckpt``, on the card and on the CPU: losses
    within rtol 1e-4 of each other and of EXPECTED_TRAIN; then ``train``
    for one full epoch on the card (dropout 0.2), its samples/s."""
    from tq_tpu_torch.data import load_mnist
    from tq_tpu_torch.evals.train_mlp import make_optimizer, train, train_step
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    start = time.perf_counter()
    batches = _mnist_batches(TRAIN_STEPS)
    losses = {}
    for d in ("cuda", "cpu"):
        params = params_from_jax(load_params(ckpt), d)
        opt, _ = make_optimizer(params)
        losses[d] = torch.stack([
            train_step(params, opt, torch.as_tensor(x, device=d),
                       torch.as_tensor(y, device=d), dropout=False)
            for x, y in batches]).cpu().tolist()
    gap_cpu = _rel_gap(losses["cuda"], losses["cpu"])
    gap_jax = _rel_gap(losses["cuda"], EXPECTED_TRAIN["mlp"]["losses"])
    if gap_cpu > 1e-4 or gap_jax > 1e-4:
        fail(f"MLP train steps: losses {gap_cpu} from the CPU's, {gap_jax} "
             "from the JAX package's (relative)")
    t0 = time.perf_counter()
    (_, ytr), _, _ = load_mnist()
    data_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, acc = train(epochs=1, verbose=False, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    samples = (len(ytr) // 64) * 64
    if not acc > 50.0:
        fail(f"one epoch of train: test accuracy {acc}%")
    emit({"phase": "mlp_train", "ok": True,
          "seconds": time.perf_counter() - start, "steps": TRAIN_STEPS,
          "loss_max_rel_gap_cpu": gap_cpu, "loss_max_rel_gap_jax": gap_jax,
          "losses": losses["cuda"], "epoch_steps": samples // 64,
          "epoch_seconds": seconds, "data_seconds": data_seconds,
          "samples_per_s": samples / (seconds - data_seconds),
          "test_acc": acc})


def _held_where_codes_agree(losses, codes, ref_losses, ref_codes):
    """(steps compared, their largest relative loss gap, steps whose weight
    codes differ): a step is compared where both runs multiplied the same
    term-revealed weights."""
    same = [k for k in range(len(losses)) if codes[k] == ref_codes[k]]
    gap = _rel_gap([losses[k] for k in same], [ref_losses[k] for k in same])
    return len(same), gap, len(losses) - len(same)


def phase_qat(torch, ckpt: Path):
    """``train_qat``'s step (Adam 1e-3, the clip) at each QAT_SETTINGS
    setting over TRAIN_STEPS batches from ``ckpt``, on the card and on the
    CPU.  Each card step held given the same parameters (the CPU's loss and
    gradients on the card's parameters, within rtol 1e-4 and GRAD_NORM_RTOL
    in norm); the free-running losses within rtol 1e-4 of the
    CPU's and of EXPECTED_TRAIN at the steps whose weight codes agree
    (``code_fingerprint``), the others counted as boundary flips.  Then
    ``run_demo`` (one epoch each) on the card."""
    from torch.utils._pytree import tree_map

    from tq_tpu_torch.evals.qat_mlp import qat_apply, qat_step, run_demo
    from tq_tpu_torch.evals.train_mlp import nll_loss, trainable
    from tq_tpu_torch.models.mlp import LAYER_NAMES
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    start = time.perf_counter()
    batches = _mnist_batches(TRAIN_STEPS)
    results = {}
    for name, setting in QAT_SETTINGS.items():
        params = params_from_jax(load_params(ckpt), "cuda")
        opt = torch.optim.Adam(trainable(params), lr=1e-3)
        snaps, grads, losses = [], [], []
        t0 = time.perf_counter()
        for x, y in batches:
            snaps.append(tree_map(lambda t: t.detach().clone(), params))
            losses.append(qat_step(params, opt, torch.as_tensor(x).cuda(),
                                   torch.as_tensor(y).cuda(), *setting))
            grads.append({n: params[n]["w"].grad.clone()
                          for n in LAYER_NAMES})
        torch.cuda.synchronize()
        card_seconds = time.perf_counter() - t0
        losses = torch.stack(losses).cpu().tolist()
        codes = [qat_fingerprints(torch, s, setting) for s in snaps]

        step_gap = grad_gap = 0.0
        for snap, g, loss, (x, y) in zip(snaps, grads, losses, batches):
            p = tree_map(lambda t: t.cpu().requires_grad_(True), snap)
            ref = nll_loss(qat_apply(p, torch.as_tensor(x), *setting),
                           torch.as_tensor(y))
            ref.backward()
            step_gap = max(step_gap, _rel_gap([loss], [ref.item()]))
            grad_gap = max([grad_gap] + [_norm_gap(g[n], p[n]["w"].grad)
                                         for n in LAYER_NAMES])
        if step_gap > 1e-4 or grad_gap > GRAD_NORM_RTOL:
            fail(f"QAT {name}: a card step given the CPU's parameters: loss "
                 f"{step_gap} (relative), gradients {grad_gap} in norm")

        cparams = params_from_jax(load_params(ckpt), "cpu")
        copt = torch.optim.Adam(trainable(cparams), lr=1e-3)
        cpu_codes, cpu_losses = [], []
        for x, y in batches:
            cpu_codes.append(qat_fingerprints(torch, cparams, setting))
            cpu_losses.append(float(qat_step(
                cparams, copt, torch.as_tensor(x), torch.as_tensor(y),
                *setting)))
        exp = EXPECTED_TRAIN[name]
        held = {"cpu": _held_where_codes_agree(losses, codes, cpu_losses,
                                               cpu_codes),
                "jax": _held_where_codes_agree(losses, codes, exp["losses"],
                                               exp["codes"])}
        for ref, (n_same, gap, _) in held.items():
            if n_same == 0 or gap > 1e-4:
                fail(f"QAT {name}: losses {gap} (relative) from the {ref} "
                     f"run's over the {n_same} steps with equal weight codes")
        results[name] = dict(
            setting=setting, card_seconds=card_seconds, losses=losses,
            same_params_loss_gap=step_gap, same_params_grad_gap=grad_gap,
            **{f"{ref}_{k}": v for ref, h in held.items()
               for k, v in zip(("steps_held", "loss_max_rel_gap",
                                "steps_with_flipped_codes"), h)})
    t0 = time.perf_counter()
    fp32_acc, ptq_acc, qat_acc = run_demo(epochs=1, verbose=False,
                                          device="cuda")
    torch.cuda.synchronize()
    demo = dict(seconds=time.perf_counter() - t0, fp32_acc=fp32_acc,
                ptq_acc=ptq_acc, qat_acc=qat_acc)
    if not all(0.0 <= v <= 100.0 for v in (fp32_acc, ptq_acc, qat_acc)):
        fail(f"run_demo: accuracies out of range {demo}")
    emit({"phase": "qat", "ok": True,
          "seconds": time.perf_counter() - start, "steps": TRAIN_STEPS,
          "results": results, "run_demo": demo})


def _init_val_loss(torch, model: str, width: int, limit_tokens):
    """``evaluate`` of the init ``train`` starts from (its default seed)
    on its validation stream."""
    from tq_tpu_torch.data.wikitext import batchify, load_corpus
    from tq_tpu_torch.evals.train_lstm import evaluate
    from tq_tpu_torch.models import lstm_lm, transformer_lm

    corpus, _ = load_corpus()
    val = np.asarray(corpus.valid)
    if limit_tokens:
        val = val[:max(limit_tokens // 10, 400)]
    gen = torch.Generator().manual_seed(1111)
    if model == "Transformer":
        params = transformer_lm.init(gen, emsize=width, nhid=width,
                                     device="cuda")
    else:
        params = lstm_lm.init(gen, emsize=width, nhid=width, cell=model,
                              device="cuda")
    return evaluate(params, batchify(val, 10), model=model)


def phase_lm_train(torch, tmp: Path):
    """The LM trainer's step at full width (LSTM 650/650/33278 tied,
    Transformer 650/2/650/2/33278; batch 20, bptt 35, lr 20, clip 0.25,
    dropout 0) over the first LM_CHUNKS chunks of the synthetic training
    stream from the seeded checkpoints, card against CPU and against
    EXPECTED_TRAIN within rtol 1e-4; tokens/s of the card's steps.  Then
    ``train`` at dropout 0.2 for one epoch: the LSTM and the Transformer
    at full width on LM_SHORT_TOKENS tokens (lr 20), GRU, RNN_TANH and
    RNN_RELU at LM_SMALL_WIDTH on LM_SMALL_TOKENS (lr LM_SMALL_LR), each
    validation loss below its init's; the best LSTM and Transformer checkpoints through
    ``evals/lstm.run_sweep`` on the card."""
    from tq_tpu_torch.data.wikitext import batchify, load_corpus
    from tq_tpu_torch.evals.lstm import run_sweep
    from tq_tpu_torch.evals.train_lstm import (_train_step,
                                               _train_step_transformer, train)
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    start = time.perf_counter()
    corpus, source = load_corpus()
    if source != "synthetic":
        fail("EXPECTED_TRAIN holds the synthetic stream's numbers; unset "
             "TQ_DATA_DIR")
    stream = batchify(np.asarray(corpus.train), LM_BATCH)
    chunks = [(stream[i:i + LM_BPTT], stream[i + 1:i + 1 + LM_BPTT]
               .reshape(-1)) for i in range(0, LM_CHUNKS * LM_BPTT, LM_BPTT)]
    steps = {}
    for name, make, model in (("lstm", lstm_checkpoint, "LSTM"),
                              ("transformer", transformer_checkpoint,
                               "Transformer")):
        ckpt = tmp / f"{name}_seeded.npz"
        make(ckpt)
        losses, chunk_seconds = {}, []
        for d in ("cuda", "cpu"):
            params = params_from_jax(load_params(ckpt), d)
            hidden = lstm_lm.init_hidden(LM_BATCH, device=d)
            out = []
            for x, y in chunks:
                t0 = time.perf_counter()
                x, y = torch.as_tensor(x, device=d), torch.as_tensor(
                    y, device=d)
                if model == "Transformer":
                    loss = _train_step_transformer(params, x, y, None, LM_LR,
                                                   LM_CLIP, 0.0, TFM_NHEAD)
                else:
                    loss, hidden = _train_step(params, x, y, hidden, None,
                                               LM_LR, LM_CLIP, 0.0, model)
                out.append(loss)
                if d == "cuda":
                    torch.cuda.synchronize()
                    chunk_seconds.append(time.perf_counter() - t0)
            losses[d] = torch.stack(out).cpu().tolist()
            del params
        gap_cpu = _rel_gap(losses["cuda"], losses["cpu"])
        gap_jax = _rel_gap(losses["cuda"], EXPECTED_TRAIN[name]["losses"])
        if gap_cpu > 1e-4 or gap_jax > 1e-4:
            fail(f"{model} train steps: losses {gap_cpu} from the CPU's, "
                 f"{gap_jax} from the JAX package's (relative)")
        steady = chunk_seconds[1:]  # the first chunk pays cuBLAS's set-up
        steps[name] = dict(
            losses=losses["cuda"], loss_max_rel_gap_cpu=gap_cpu,
            loss_max_rel_gap_jax=gap_jax, chunk_seconds=chunk_seconds,
            tokens_per_s=len(steady) * LM_BATCH * LM_BPTT / sum(steady))

    runs = {}
    small = (LM_SMALL_WIDTH, LM_SMALL_TOKENS, LM_SMALL_LR)
    for model, (width, limit, lr) in (
            ("LSTM", (650, LM_SHORT_TOKENS, LM_LR)),
            ("Transformer", (650, LM_SHORT_TOKENS, LM_LR)),
            ("GRU", small), ("RNN_TANH", small), ("RNN_RELU", small)):
        init_val = _init_val_loss(torch, model, width, limit)
        save = tmp / f"{model}_trained.npz"
        t0 = time.perf_counter()
        _, best_val = train(epochs=1, emsize=width, nhid=width, lr=lr,
                            limit_tokens=limit, verbose=False, model=model,
                            save_path=save, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not best_val < init_val:
            fail(f"{model}: validation loss {best_val} after one epoch, "
                 f"{init_val} at the init")
        trained = (limit // LM_BATCH - 1) * LM_BATCH
        runs[model] = dict(width=width, lr=lr, init_val_loss=init_val,
                           best_val_loss=best_val, seconds=seconds,
                           tokens=trained, tokens_per_s=trained / seconds)
    sweeps = {}
    for model in ("LSTM", "Transformer"):
        res = run_sweep([8], [8], [8], [8], [1],
                        checkpoint=str(tmp / f"{model}_trained.npz"),
                        limit_tokens=2000, verbose=False, model=model,
                        device="cuda")
        if not (len(res["ppls"]) == 1 and np.isfinite(res["ppls"][0])):
            fail(f"run_sweep on the trained {model} checkpoint: {res}")
        sweeps[model] = res
    emit({"phase": "lm_train", "ok": True,
          "seconds": time.perf_counter() - start, "chunks": LM_CHUNKS,
          "steps": steps, "runs": runs, "sweeps": sweeps})


# ----------------------------------------------------------- phases 24-29


# The oracle phase's settings (tests/test_native_oracle.py's and the
# Python oracle's): (bits, group_size, budget).  A million elements, 1024
# to a row; g = 5 leaves a short last group in every row.
ORACLE_SETTINGS = [(8, 1, 3), (9, 8, 12), (9, 32, 40), (4, 16, 14),
                   (6, 5, 7)]
ORACLE_SHAPE = (1024, 1024)
# Two of the README's MLP settings as a RunConfig (wb, wt, db, dt, gs):
# the first of each sweep of EXPECTED_SWEEPS.
CONFIG_SETTINGS = {"mnist-quant": [2, 2, 6, 6, 1], "mnist-tr": [4, 6, 6, 6, 16]}


def _counted(torch, fn, *args):
    """(``fn(*args)``, the launches it made): the counts set to 0 before,
    read after a synchronize."""
    _reset_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, _read_counts()


def _sum_counts(*counts: dict) -> dict:
    """Launches per kernel row, summed over phases."""
    return {k: sum(c.get(k, 0) for c in counts)
            for k in set().union(*counts)}


class _PathCounts:
    """The launches of a path's own calls: ``self(fn, *args)`` runs
    ``fn`` and adds what it launched to ``total`` (``last`` is that call's
    alone); checks, reference runs and timing repeats run outside it.  A
    wrapper counts where it launches, on the host, so no synchronize is
    needed."""

    def __init__(self):
        self.total: dict = {}
        self.last: dict = {}

    def __call__(self, fn, *args, **kwargs):
        before = _read_counts()
        out = fn(*args, **kwargs)
        self.last = {k: n - before[k] for k, n in _read_counts().items()}
        self.total = _sum_counts(self.total, self.last)
        return out


def _leaf_model(torch, ckpt: Path, device: str):
    """The flagship's converted ResNet-18 (every scale 0.05) and its
    images, on ``device``."""
    from tq_tpu_torch.convert import convert_cnn, static_conv_layer_settings
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.models import resnet

    f = FLAGSHIP
    _, params = load_params("resnet18", str(ckpt), device=device)
    settings = static_conv_layer_settings(resnet.conv_specs(), *f["tr"])
    qp, qc, qs = convert_cnn(resnet, params, settings, f["db"], f["dt"])
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(f["batch"], f["image"], f["image"], 3)).astype(np.float32),
        device=device)
    return params, qp, qc, _with_sf(torch, qs, f["sf"]), x


def phase_empirical(torch, ckpt: Path):
    """The empirical term-pair profiler on the flagship model at 224x224,
    batch 16: conversion and ``empirical_cnn_cost`` on the card (counted);
    its capture and counting halves timed apart; the card's captures
    counted again on the CPU (equal); every layer within its analytic
    budget, and its deviation from the avg-terms factorization; on
    layer4.1.conv1 (a full-channel conv) the plane-pair map summed equal
    to the count-map total."""
    from tq_tpu_torch.layers.quantize import act_quantize
    from tq_tpu_torch.models import resnet
    from tq_tpu_torch.profilers import conv2d_term_macs
    from tq_tpu_torch.profilers.empirical import (captured_cost,
                                                  capture_activations,
                                                  conv_term_pair_map,
                                                  conv_term_pair_total,
                                                  empirical_cnn_cost)

    f = FLAGSHIP
    specs = resnet.conv_specs(f["image"])

    def drive():
        _, qp, qc, qs, x = _leaf_model(torch, ckpt, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = empirical_cnn_cost(resnet, qp, qs, qc, x, specs)
        torch.cuda.synchronize()
        return (qp, qc, qs, x), report, time.perf_counter() - t0

    t0 = time.perf_counter()
    ((qp, qc, qs, x), report, call_s), launches = _counted(torch, drive)
    path_s = time.perf_counter() - t0
    if launches["tr_quantize_grouped"] != 19 or \
            launches["tr_quantize_elementwise"] != 2 * 19:
        fail(f"empirical: launches {launches}, not B2 19 (conversion) and "
             "B1 38 (the forward and the counting)")

    # A warm call, then its two halves timed apart; the card's counts on
    # its captures.
    t0 = time.perf_counter()
    empirical_cnn_cost(resnet, qp, qs, qc, x, specs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    captured = capture_activations(resnet, qp, qs, qc, x)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = captured_cost(captured, qp, qs, qc, specs, f["batch"])
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    if card != report:
        fail("empirical: the counts of a second capture differ from "
             "empirical_cnn_cost's")

    # The same captures counted on the CPU.
    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(cpu(v) for v in tree)
        return tree.cpu() if isinstance(tree, torch.Tensor) else tree

    t0 = time.perf_counter()
    host = captured_cost(cpu(captured), cpu(qp), cpu(qs), qc, specs,
                         f["batch"])
    cpu_count_s = time.perf_counter() - t0
    if host != card:
        bad = [n for n in card if host.get(n) != card[n]]
        fail(f"empirical: card and CPU counts differ on the same captures "
             f"at {bad}")

    by_name = {s.name: s for s in specs}
    deviation, budget_share = {}, {}
    for name, r in card.items():
        s = by_name[name]
        analytic = f["batch"] * conv2d_term_macs(s.out_elems, s.in_ch, s.kh,
                                                 s.kw, qc[name], s.groups)
        if not 0 < r["pairs"] <= analytic:
            fail(f"empirical {name}: {r['pairs']} pairs against the "
                 f"analytic budget {analytic}")
        budget_share[name] = r["pairs"] / analytic
        model = r["avg_dt"] * r["avg_wt_elem"] * r["effective_macs"]
        deviation[name] = model / r["pairs"] - 1.0
    if len(card) != 19:
        fail(f"empirical: {len(card)} layers counted, not 19")

    # The plane-pair identity on a whole layer4 conv.
    name = "layer4.1.conv1"
    xin, stride, padding, _ = captured[name]
    tr, sf = qc[name], qs[name]["sf"]
    xq = act_quantize(xin, sf, tr.data_bits, tr.data_terms)
    w_q, w_sf = qp[name]["w"], qp[name]["w_sf"]
    t0 = time.perf_counter()
    pair_map = conv_term_pair_map(xq, w_q, sf, w_sf, tr.data_bits,
                                  tr.weight_bits, stride, padding)
    map_total = int(pair_map.sum())
    map_s = time.perf_counter() - t0
    total = conv_term_pair_total(xq, w_q, sf, w_sf, tr.data_bits,
                                 tr.weight_bits, stride, padding)
    if map_total != total or total != card[name]["pairs"]:
        fail(f"empirical {name}: plane-pair map sums to {map_total}, count "
             f"maps to {total}, the report {card[name]['pairs']}")
    emit({"phase": "empirical", "ok": True, "image": f["image"],
          "batch": f["batch"], "setting": f["tr"] + (f["db"], f["dt"]),
          "path_seconds": path_s, "first_call_seconds": call_s,
          "warm_call_seconds": warm_s,
          "capture_seconds": capture_s, "count_seconds": count_s,
          "cpu_count_seconds": cpu_count_s,
          "launches": {k: v for k, v in launches.items() if v},
          "pairs": sum(r["pairs"] for r in card.values()),
          "budget": sum(r["pairs"] / budget_share[n]
                        for n, r in card.items()),
          "max_abs_deviation": max(abs(d) for d in deviation.values()),
          "deviation": deviation, "budget_share": budget_share,
          "layer4_map": {"layer": name, "shape": list(pair_map.shape),
                         "total": total, "seconds": map_s},
          "report": card})
    return launches


def phase_config(torch, tmp: Path):
    """A RunConfig of two README MLP settings through ``config.run`` on
    the card (counted; B1 calibrates and quantizes the activations, B2
    reveals the weights): its columns equal ``run_sweep`` called directly
    and EXPECTED_SWEEPS' (the main path's)."""
    from tq_tpu_torch.config import load_config, run
    from tq_tpu_torch.evals.mlp import run_sweep

    cfg_path = tmp / "mlp_config.json"
    cfg_path.write_text(json.dumps({
        "workload": "mlp", "settings": list(CONFIG_SETTINGS.values()),
        "checkpoint": str(CHECKPOINT), "out_file": str(tmp / "cfg.json")}))
    cfg = load_config(cfg_path)
    t0 = time.perf_counter()
    got, launches = _counted(torch, run, cfg, "cuda")
    seconds = time.perf_counter() - t0
    # The README sweeps multiply the raw dense inputs (the reference
    # layer, as the JAX package's run does): no term_matmul.
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_grouped"], "config")
    cols = list(zip(*CONFIG_SETTINGS.values()))
    direct = run_sweep(*cols, None, checkpoint=str(CHECKPOINT),
                       verbose=False, device="cuda")
    if got != direct:
        fail(f"config: {got} != run_sweep's {direct}")
    if json.loads((tmp / "cfg.json").read_text()) != got:
        fail("config: the out_file differs from the returned columns")
    for i, sweep in enumerate(CONFIG_SETTINGS):
        exp = EXPECTED_SWEEPS[sweep]
        for key in ("accs", "tmacs", "param_bits"):
            if got[key][i] != float(exp[key][0]):
                fail(f"config {sweep} {key}: {got[key][i]} != "
                     f"{exp[key][0]}")
    emit({"phase": "config", "ok": True, "seconds": seconds,
          "settings": CONFIG_SETTINGS, "results": got,
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


# Kernel-name fragments of the port's kernels in a trace, by counter row.
TRACE_KERNELS = {"tr_quantize_elementwise": "tr_elementwise_kernel",
                 "tr_quantize_grouped": "tr_grouped_kernel",
                 "tr_scale_copy": "tr_scale_copy_kernel",
                 "term_matmul_kernel_mma": "term_matmul_mma_kernel",
                 "term_matmul_kernel_mma_lp": "term_matmul_mma_lp_kernel"}


def _kind(name: str) -> str:
    """A coarse class of a device kernel by its name."""
    low = name.lower()
    for frag in TRACE_KERNELS.values():
        if frag in name:
            return frag
    for kind, words in (("layout transpose", ("nhwctonchw", "nchwtonhwc")),
                        ("convolution", ("conv", "implicit_gemm", "winograd",
                                         "cudnn")),
                        ("matmul", ("gemm", "splitkreduce")),
                        ("max_pool", ("pool",)),
                        ("reduction", ("reduce",)),
                        ("element-wise", ("elementwise", "vectorized",
                                          "unrolled"))):
        if any(w in low for w in words):
            return kind
    return "other"


def phase_trace(torch, ckpt: Path, tmp: Path):
    """One flagship forward (224x224, batch 16) inside
    ``utils/trace.device_trace``: the Chrome trace's kernel events of each
    of the port's kernels equal its launch counter, and where the card's
    time goes by kernel class.  The device's idle share is its busy time
    against the host time of the same forward untraced (the median of
    five warm calls): the profiler adds host time to every operation."""
    from tq_tpu_torch.convert import make_cnn_apply
    from tq_tpu_torch.models import resnet
    from tq_tpu_torch.utils.trace import TRACE_FILE, device_trace

    _, qp, qc, qs, x = _leaf_model(torch, ckpt, "cuda")
    forward = make_cnn_apply(resnet, qc, track=False)
    forward(qp, qs, x)  # warm: cuDNN's first call chooses its kernels
    torch.cuda.synchronize()
    untraced = []
    for _ in range(5):
        t0 = time.perf_counter()
        forward(qp, qs, x)
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3)
    host_ms = float(np.median(untraced))

    def traced():
        with device_trace(tmp, "flagship_forward") as path:
            t0 = time.perf_counter()
            logits, _ = forward(qp, qs, x)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        return path, logits, traced_ms

    (path, logits, traced_ms), launches = _counted(torch, traced)
    if not bool(torch.isfinite(logits).all()):
        fail("trace: the traced forward's logits are not finite")
    events = json.loads((path / TRACE_FILE).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        fail("trace: no kernel events in the trace (no device activity "
             "recorded)")
    for row, frag in TRACE_KERNELS.items():
        n = sum(frag in e["name"] for e in kernels)
        if n != launches[row]:
            fail(f"trace: {n} {frag} events against {launches[row]} "
                 f"launches counted")
    if launches["tr_quantize_elementwise"] != 19:
        fail(f"trace: {launches['tr_quantize_elementwise']} B1 launches, "
             "not 19")
    by_kind: dict = {}
    for e in kernels:
        k = by_kind.setdefault(_kind(e["name"]), {"us": 0.0, "launches": 0})
        k["us"] += e["dur"]
        k["launches"] += 1
    busy = sum(e["dur"] for e in kernels)
    span = (max(e["ts"] + e["dur"] for e in kernels)
            - min(e["ts"] for e in kernels))
    top: dict = {}
    for e in kernels:
        t = top.setdefault(e["name"][:120], [0.0, 0])
        t[0] += e["dur"]
        t[1] += 1
    emit({"phase": "trace", "ok": True, "host_ms": host_ms,
          "host_ms_calls": untraced, "traced_host_ms": traced_ms,
          "kernel_events": len(kernels),
          "device_busy_us": busy, "device_span_us": span,
          "idle_share_of_span": 1.0 - busy / span,
          "idle_share_of_host": 1.0 - busy / (host_ms * 1e3),
          "by_kind": dict(sorted(by_kind.items(),
                                 key=lambda kv: -kv[1]["us"])),
          "top_kernels": sorted(([n, us, c] for n, (us, c) in top.items()),
                                key=lambda r: -r[1])[:10],
          "memcpy_events": sum(e.get("cat") == "gpu_memcpy" for e in events),
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


def phase_oracle(torch):
    """B1 and B2 on the card bit for bit against the native C++ oracle
    (``utils/native.tr_reveal_native``, a third reference independent of
    both packages) on a million elements, grouped along the rows, at
    ORACLE_SETTINGS; each timed there beside its plain version."""
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize, tr_quantize_ref
    from tq_tpu_torch.utils.native import tr_reveal_native

    x_np = (np.random.default_rng(5).normal(size=ORACLE_SHAPE) * 3).astype(
        np.float32)
    x = torch.as_tensor(x_np, device="cuda")
    sf = torch.tensor(0.04, device="cuda")
    cells = {"tr_quantize_elementwise": {}, "tr_quantize_grouped": {}}
    native_s = 0.0
    for bits, g, k in ORACLE_SETTINGS:
        t0 = time.perf_counter()
        want = tr_reveal_native(x_np, 0.04, bits, g, k)
        native_s += time.perf_counter() - t0
        got = tr_quantize(x, sf, bits, g, k, axis=-1).cpu().numpy()
        if not np.array_equal(got, want):
            bad = int((got != want).sum())
            fail(f"oracle bits={bits} g={g} k={k}: {bad} of {want.size} "
                 "values differ from the native oracle")
        row = "tr_quantize_elementwise" if g == 1 else "tr_quantize_grouped"
        n = x.numel()
        cells[row][f"1024x1024_b{bits}_g{g}_k{k}"] = dict(
            bits=bits, group_size=g, terms=k, **_cell(
                torch, lambda: tr_quantize(x, sf, bits, g, k, axis=-1),
                lambda: tr_quantize_ref(x, sf, bits, g, k, axis=-1),
                8 * n, n))
    emit({"phase": "oracle", "ok": True, "shape": list(ORACLE_SHAPE),
          "settings": ORACLE_SETTINGS, "native_seconds": native_s,
          "results": cells})
    return cells


def phase_viz(torch, ckpt: Path):
    """The figures' compute functions on the card against the CPU:
    ``layer_errors`` on every converted ResNet-18 conv (the weights term
    revealed by B2 and B1 on the card, bit for bit with the CPU's; the
    float64 norms, summed in another order, within 1e-9: one weight code
    off would move an error by more than 1e-7) and ``group_term_counts``
    (exact).  Nothing plots and matplotlib is not imported."""
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.models import resnet
    from tq_tpu_torch.viz.quant_error import layer_errors
    from tq_tpu_torch.viz.term_dist import group_term_counts

    _, params = load_params("resnet18", str(ckpt), device="cuda")
    _, params_c = load_params("resnet18", str(ckpt), device="cpu")
    worst = 0.0

    def errors():
        return {s: layer_errors(resnet, params, s)
                for s in ((8, 1, 8), (9, 8, 12))}

    card, launches = _counted(torch, errors)
    for s, errs in card.items():
        for (name, e), (_, ec) in zip(errs, layer_errors(resnet, params_c,
                                                         s)):
            worst = max(worst, abs(e - ec) / ec)
            if abs(e - ec) > 1e-9 * ec:
                fail(f"viz layer_errors {s} {name}: card {e} cpu {ec}")
    counts = 0
    for name in ("layer1.0.conv1", "layer3.0.conv1", "layer4.1.conv2"):
        for g in (1, 8, 16):
            got = group_term_counts(params[name]["w"], 9, g)
            if not np.array_equal(got, group_term_counts(
                    params_c[name]["w"], 9, g)):
                fail(f"viz group_term_counts {name} g={g}: card != cpu")
            counts += got.size
    if "matplotlib" in sys.modules:
        fail("viz: matplotlib was imported")
    emit({"phase": "viz", "ok": True, "layers": len(card[(9, 8, 12)]),
          "max_rel_gap": worst, "group_counts": counts,
          "errors": {str(s): e for s, e in card.items()},
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


def phase_example(torch):
    """``tq_tpu_torch.examples.quantize_resnet18`` at 224 on the card, its
    ``main`` as ``python -m`` calls it, in this process (counted): its
    cost lines equal ``cnn_cost`` and ``param_count``, and the serving
    mode's top-1 agrees with the float32 forward's."""
    import contextlib
    import io

    from tq_tpu_torch.convert import static_conv_layer_settings
    from tq_tpu_torch.examples.quantize_resnet18 import main as example
    from tq_tpu_torch.models import resnet
    from tq_tpu_torch.profilers import cnn_cost, param_count

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _, launches = _counted(torch, example, [])
    seconds = time.perf_counter() - t0
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_elementwise_bf16",
                                 "tr_quantize_grouped"], "example")
    specs = resnet.conv_specs()
    tmacs, avg = cnn_cost(specs, static_conv_layer_settings(specs, 9, 8, 12),
                          9, 3)
    n_params = param_count(resnet.init(torch.Generator(), device="meta"))
    out = buf.getvalue()
    for line in (f"term-pair MACs/img: {tmacs:,}  avg terms/value: {avg}",
                 f"params: {n_params:,}", "serving-mode top-1 agrees: True"):
        if line not in out:
            fail(f"example: no line {line!r} in its output:\n{out}")
    emit({"phase": "example", "ok": True, "seconds": seconds,
          "output": out.splitlines(),
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


class _NoPlainOnCard:
    """Inside: the plain version of ``tr_quantize``, ``term_matmul`` or
    ``histogram`` called on a CUDA tensor fails the run (the path must
    launch the kernels); on CPU tensors (the comparisons) they run as
    usual."""

    def __enter__(self):
        import tq_tpu_torch.kernels.histogram as hg
        import tq_tpu_torch.kernels.term_matmul as tm
        import tq_tpu_torch.kernels.tr_quantize as tq

        def guard(fn):
            def on_cpu_only(x, *args, **kwargs):
                if x.is_cuda:
                    fail(f"{fn.__name__} (the plain version) ran on the card")
                return fn(x, *args, **kwargs)
            return on_cpu_only

        self.saved = [(tq, "tr_quantize_ref", tq.tr_quantize_ref),
                      (tm, "term_matmul_ref", tm.term_matmul_ref),
                      (hg, "histogram_ref", hg.histogram_ref)]
        for module, name, fn in self.saved:
            setattr(module, name, guard(fn))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)
        return False


# -------------------------------------------------------------- group par
#
# The port's parallel/ on one card: world 1 over NCCL in this process,
# world 2 over gloo in two ranks that share the card (NCCL refuses two
# ranks on one device; phase par records what it says).  No multi-GPU
# run: every world-2 number is of two processes on one card.

PAR_SEED = 0
PAR_TOKENS = (35, 10)      # the decoder at M = 350
PAR_PROMPT = (5, 1)        # T <= STREAM_MAX_M at batch 1: streaming kernel
PAR_SF = 0.05              # every Transformer quantizer's scale
PAR_TP_SHAPES = [(128, 784, 512), (350, 650, 2600)]
PAR_REQUESTS, PAR_BATCH, PAR_WORDS = 131, 64, 16
PAR_LSTM_SF = 0.01         # the LSTM's activation scale (|h|, |c| < 2.55)
PAR_PIPE = dict(width=512, n_micro=8, micro_batch=32, in_dim=784)
PAR_TIMED = [(350, 650, VOCAB // 2), (350, 650, VOCAB)]
PAR_EXAMPLES = [("sharded_inference", "served 100 requests"),
                ("pipeline_inference", "pipelined 8 microbatches"),
                ("lm_serving", "served 51 generation requests")]


def _par_close(got, want, rtol: float, what: str, atol=None) -> float:
    """Fail unless ``got`` is within rtol and atol (default: 1e-4 *
    max|want|, the sum-order class) of ``want``; the max |diff|."""
    import torch

    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)}, not {tuple(want.shape)}")
    if atol is None:
        atol = 1e-4 * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{what}: max |diff| {err}")
    return err


def _par_transformer(torch, spec: dict, mesh) -> dict:
    """The Transformer LM at full width, decoder u8s and column-parallel
    over 'model': raw input (mma, f32_raw_packed8) and quantized input
    (mma_lp, bf16_packed8) at tokens (35, 10), and a 5-token prompt at
    batch 1 (the streaming kernel); at world 1 bit for bit with the
    unsharded forward.  Tokens/s of the TP forward (host clock ending in a
    synchronize; two ranks share one card at world 2)."""
    import torch.distributed as dist

    from tq_tpu_torch.models import transformer_lm as tl
    from tq_tpu_torch.parallel.sharding import shard_pytree
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    params = params_from_jax(load_params(spec["tfm_ckpt"]), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(GEN_SEED).integers(
        0, VOCAB, PAR_TOKENS), device="cuda")
    prompt = tokens[:PAR_PROMPT[0], :PAR_PROMPT[1]].contiguous()
    out = {}
    for branch in ("raw", "quantized"):
        qp, qc, qs = tl.convert(params, 8, 8, 24, 8, 8,
                                quantize_input=branch == "quantized")
        qs = _with_sf(torch, qs, PAR_SF)
        qp = tl.pack(qp, qc, fmt="u8s")
        tp_qp = shard_pytree(qp, tl.tp_param_specs(), mesh)
        fwd = tl.make_tp_quantized_apply(qc, mesh)
        with torch.no_grad():
            logp, _ = fwd(tp_qp, qs, tokens)
            logp_p, _ = fwd(tp_qp, qs, prompt)
            if not (bool(torch.isfinite(logp).all())
                    and bool(torch.isfinite(logp_p).all())):
                fail(f"par transformer {branch}: log-probs not finite")
            r = {"decoder_shard": list(tp_qp["decoder"]["w"].lo.shape)}
            if dist.get_world_size() == 1:
                ref = tl.make_quantized_apply(qc, track=False)
                for name, got, toks in (("tokens", logp, tokens),
                                        ("prompt", logp_p, prompt)):
                    want, _ = ref(qp, qs, toks)
                    if not torch.equal(got, want):
                        fail(f"par transformer {branch} {name}: the (1, 1) "
                             "mesh's forward is not bit for bit the "
                             "unsharded one (max |diff| "
                             f"{float((got - want).abs().max())})")
                r["bit_equal_unsharded"] = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fwd(tp_qp, qs, tokens)
            torch.cuda.synchronize()
        r["tokens_per_s_one_shared_card"] = (
            5 * tokens.numel() / (time.perf_counter() - t0))
        r["logp"] = logp.cpu().numpy()
        r["prompt_logp"] = logp_p.cpu().numpy()
        out[branch] = r
        del qp, tp_qp, logp, logp_p
    return out


def _par_codes(torch, qp, qs, tr, tok, hidden):
    """Per batch row, an int64 fingerprint of the rounded activation
    levels min(floor(|v|/sf + 0.5), 2^bits - 1) * sign(v) that the LSTM's
    quantizer sees at this step (the embedding, h and c of every layer);
    plain tensor code on the card, no kernel.  Equal fingerprints: the
    same quantized inputs (the kept terms are a function of the level)."""
    sf = qs["rnn"]["sf"]
    fp = torch.zeros(tok.shape[1], dtype=torch.int64, device=tok.device)
    vals = [qp["encoder"]["w"][tok.long()][0]] + [
        t[i] for t in hidden for i in range(t.shape[0])]
    for v in vals:
        level = torch.clamp(torch.floor(v.abs() / sf + 0.5),
                            max=2 ** tr.data_bits - 1)
        q = (level * torch.sign(v)).to(torch.int64)
        c = (torch.arange(q.shape[1], device=q.device, dtype=torch.int64)
             * 2654435761) % (1 << 31) + 1
        fp = fp * 1000003 + (q * c).sum(dim=1)
    return fp


def _par_serving(torch, spec: dict, mesh) -> dict:
    """``BatchRunner`` over 'data': the full-width LSTM LM packed as
    bench.py::bench_generate packs it (u8s, the recurrent weights too),
    PAR_REQUESTS one-token prompts in batches of PAR_BATCH (the tail
    padded), PAR_WORDS greedy tokens each; every rank runs its rows
    (M = PAR_BATCH / world, on the mma kernel).  Returns each request's
    tokens, the log-prob of each chosen token and the quantized inputs'
    fingerprints, gathered in request order."""
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.parallel.serving import BatchRunner
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    params = params_from_jax(load_params(spec["lstm_ckpt"]), "cuda")
    qp, qc, qs = lstm_lm.convert(params, 8, 8, 24, 8, 8)
    qs = _with_sf(torch, qs, PAR_LSTM_SF)
    qpk = lstm_lm.pack(qp, qc, fmt="u8s", rnn=True)
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    H = params["rnn"][0]["w_hh"].shape[0]

    def serve(tok0):
        B = tok0.shape[0]
        hidden = lstm_lm.init_hidden(B, nhid=H, device="cuda")
        tok = tok0.T.contiguous()
        toks, lps, fps = [], [], []
        with torch.no_grad():
            for _ in range(PAR_WORDS):
                fps.append(_par_codes(torch, qpk, qs, qc["rnn"], tok, hidden))
                logp, hidden, _ = fwd(qpk, qs, tok, hidden)
                nxt = logp.argmax(-1)
                lps.append(logp.gather(1, nxt[:, None])[:, 0])
                toks.append(nxt)
                tok = nxt[None, :]
        return (torch.stack(toks, 1), torch.stack(lps, 1),
                torch.stack(fps, 1))

    runner = BatchRunner(serve, mesh, batch_size=PAR_BATCH)
    rng = np.random.default_rng(GEN_SEED)
    requests = [np.asarray([t]) for t in rng.integers(0, VOCAB,
                                                      PAR_REQUESTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = runner.run_all(requests)
    seconds = time.perf_counter() - t0
    return {"tokens": np.stack([r[0] for r in results]),
            "logp": np.stack([r[1] for r in results]),
            "codes": np.stack([r[2] for r in results]),
            "seconds": seconds,
            "tokens_per_s_one_shared_card":
                PAR_REQUESTS * PAR_WORDS / seconds}


def _par_tp(torch, mesh) -> dict:
    """The four TP functions at PAR_TP_SHAPES in three modes (f32 on
    float32 weights: mma; int8 on int8 weights: mma_lp; bf16 on int16
    weights: mma_lp) and the column-parallel 9-bit pack (bf16 and raw),
    each gathered and held against the unsharded port call on the card:
    column-parallel in the sum-order class, its int8 mode bit for bit;
    row-parallel and the ring rtol 1e-4, atol 1e-4."""
    from tq_tpu_torch.kernels.term_matmul import (pack_weight_int,
                                                  pack_weight_u8s,
                                                  term_matmul)
    from tq_tpu_torch.layers.common import TRParams, quantize_weight
    from tq_tpu_torch.parallel import tp
    from tq_tpu_torch.parallel._compat import all_gather
    from tq_tpu_torch.parallel.sharding import P, shard, shard_pytree

    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    errs = {}
    for M, K, N in PAR_TP_SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda")
        wf = torch.randn(K, N, generator=gen, device="cuda") * 0.1
        wq7, s7 = quantize_weight(wf, TRParams(7, 8, 12, 7, 3), axis=0)
        wq8, s8 = quantize_weight(wf, TRParams(8, 8, 24, 8, 3), axis=0)
        w8, w8_sf = pack_weight_int(wq7, s7, 7)
        w16, w16_sf = pack_weight_int(wq8, s8, 8)
        modes = {"f32": (wf, None, 0.04, 8, {}),
                 "int8": (w8, w8_sf, 0.05, 7, {"int8": True}),
                 "bf16_int16": (w16, w16_sf, 0.05, 8, {"bf16": True})}
        for mode, (w, w_sf, sf, bits, kw) in modes.items():
            ref = term_matmul(x, w, sf, bits, 3, w_sf=w_sf, **kw)
            col = all_gather(tp.tp_term_matmul_col(
                x, shard(w, P(None, "model"), mesh), sf, bits, 3, mesh,
                w_sf=w_sf, **kw), mesh, "model", axis=1)
            row = tp.tp_term_matmul_row(
                shard(x, P(None, "model"), mesh),
                shard(w, P("model", None), mesh), sf, bits, 3, mesh,
                w_sf=w_sf, **kw)
            ring = all_gather(tp.tp_term_matmul_overlap(
                shard(x, P(None, "model"), mesh),
                shard(w, P(None, "model"), mesh), sf, bits, 3, mesh,
                w_sf=w_sf, **kw), mesh, "model", axis=1)
            key = f"{mode} {M}x{K}x{N}"
            if mode == "int8" and not torch.equal(col, ref):
                fail(f"par tp col {key}: not bit for bit")
            errs[f"col {key}"] = _par_close(col, ref, 1e-5,
                                            f"par tp col {key}")
            errs[f"row {key}"] = _par_close(row, ref, 1e-4,
                                            f"par tp row {key}", atol=1e-4)
            errs[f"overlap {key}"] = _par_close(ring, ref, 1e-4,
                                                f"par tp overlap {key}",
                                                atol=1e-4)
        wp = pack_weight_u8s(wq8, s8, 8)
        wpl = shard_pytree(wp, P(None, "model"), mesh)
        for branch, sf, kw in (("bf16", 0.04, {}),
                               ("raw", 1.0, {"bf16": False,
                                             "quantize_x": False})):
            ref = term_matmul(x, wp, sf, 8, 3, bf16=kw.get("bf16", True),
                              quantize_x=kw.get("quantize_x", True))
            got = all_gather(tp.tp_term_matmul_col_packed(
                x, wpl, sf, 8, 3, mesh, **kw), mesh, "model", axis=1)
            key = f"col_packed {branch} {M}x{K}x{N}"
            errs[key] = _par_close(got, ref, 1e-5, f"par tp {key}")
    return errs


def _par_pipeline(torch, mesh) -> dict:
    """``build_mlp_pipeline`` at width 512 over 'stage', forward and
    gradients against the same parameters run stage after stage on the
    card (within 1e-5); the TR trunk (``make_tr_block_fn(7, 3)``, 8
    microbatches of 32) against the sequential blocks, B1 launched on
    every tick of every stage."""
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.parallel._compat import axis_size, psum
    from tq_tpu_torch.parallel.pp import (build_mlp_pipeline,
                                          make_tr_block_fn, pipeline_apply)

    S = axis_size(mesh, "stage")
    p = PAR_PIPE
    params, forward = build_mlp_pipeline(
        torch.Generator().manual_seed(PAR_SEED), S, width=p["width"],
        in_dim=p["in_dim"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    x = torch.randn(p["n_micro"], p["micro_batch"], p["in_dim"],
                    generator=gen, device="cuda")
    leaves = [(g, k) for g in params for k in params[g]]
    for g, k in leaves:
        params[g][k].requires_grad_(True)
    logp = forward(params, x, mesh)
    (logp ** 2).sum().backward()
    # The trunk's and the stem's gradients live on the stage that used
    # them: summed over 'stage'; the head's is whole on every rank.
    grads = {f"{g}.{k}": (psum(params[g][k].grad, mesh, "stage")
                          if g != "head" else params[g][k].grad)
             for g, k in leaves}
    seq = {g: {k: v.detach().clone().requires_grad_(True)
               for k, v in d.items()} for g, d in params.items()}

    def block(q, h):
        return torch.relu(torch.matmul(h, q["w"]) + q["b"])

    h = torch.relu(torch.einsum("mbi,io->mbo", x, seq["stem"]["w"])
                   + seq["stem"]["b"])
    for s in range(S):
        h = block({k: v[s] for k, v in seq["trunk"].items()}, h)
    want = torch.log_softmax(torch.einsum("mbi,io->mbo", h, seq["head"]["w"])
                             + seq["head"]["b"], dim=-1)
    (want ** 2).sum().backward()
    out = {"logp": _par_close(logp.detach(), want.detach(), 1e-5,
                              "par pipeline forward", atol=1e-5)}
    for g, k in leaves:
        ref = seq[g][k].grad
        out[f"grad {g}.{k}"] = _par_close(
            grads[f"{g}.{k}"], ref, 1e-5, f"par pipeline gradient {g}.{k}",
            atol=1e-5 * max(1.0, float(ref.abs().max())))

    width = p["width"]
    trunk = {"w": torch.randn(S, width, width, generator=gen,
                              device="cuda") * 0.05,
             "b": torch.zeros(S, width, device="cuda"),
             "w_sf": torch.full((S,), 0.01, device="cuda"),
             "a_sf": torch.full((S,), 0.05, device="cuda")}
    xt = torch.randn(p["n_micro"], p["micro_batch"], width, generator=gen,
                     device="cuda")
    tr_block = make_tr_block_fn(7, 3)
    before = tr_quantize.launches["elementwise"]
    with torch.no_grad():
        y = pipeline_apply(trunk, xt, tr_block, mesh)
        torch.cuda.synchronize()
        ticks = tr_quantize.launches["elementwise"] - before
        if ticks != p["n_micro"] + S - 1:
            fail(f"par pipeline TR trunk: {ticks} B1 launches on this "
                 f"rank, not one a tick ({p['n_micro'] + S - 1})")
        hs = xt
        for s in range(S):
            hs = tr_block({k: v[s] for k, v in trunk.items()}, hs)
    out["tr_trunk"] = _par_close(y, hs, 1e-5, "par pipeline TR trunk",
                                 atol=1e-5)
    out["tr_ticks_b1"] = ticks
    return out


def _par_train(torch, mesh) -> dict:
    """One DP x TP MLP step at dropout 0 on the card against the
    single-device step: loss rtol 1e-5, parameters rtol 1e-4."""
    from tq_tpu_torch.evals import train_mlp
    from tq_tpu_torch.models import mlp
    from tq_tpu_torch.parallel._compat import all_gather
    from tq_tpu_torch.parallel.sharding import mlp_param_specs, shard_pytree
    from tq_tpu_torch.parallel.train import make_sharded_train_step

    def init():
        return mlp.init(torch.Generator().manual_seed(PAR_SEED),
                        device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    x = torch.randn(64, 1, 28, 28, generator=gen, device="cuda")
    y = torch.randint(0, 10, (64,), generator=gen, device="cuda")
    specs = mlp_param_specs()
    params = shard_pytree(init(), specs, mesh)
    opt = torch.optim.Adadelta(train_mlp.trainable(params), lr=1.0)
    loss = make_sharded_train_step(opt, mesh)(params, x, y, dropout=False)
    single = init()
    opt1 = torch.optim.Adadelta(train_mlp.trainable(single), lr=1.0)
    loss1 = train_mlp.train_step(single, opt1, x, y, dropout=False)
    out = {"loss": float(loss), "single_loss": float(loss1)}
    _par_close(loss, loss1, 1e-5, "par train loss", atol=0.0)
    for name, leaves in specs.items():
        for leaf, spec in leaves.items():
            t = params[name][leaf].detach()
            for axis, dim in enumerate(spec):
                if dim is not None:
                    t = all_gather(t, mesh, dim, axis=axis)
            out[f"{name}.{leaf}"] = _par_close(
                t, single[name][leaf].detach(), 1e-4,
                f"par train {name}.{leaf}", atol=1e-7)
    return out


def _par_checkpoint(torch, spec: dict, mesh) -> dict:
    """The TP-sharded MLP saved by every rank
    (``save_params_orbax``, ``torch.distributed.checkpoint``) and read
    back into zeroed shards: bit for bit."""
    from tq_tpu_torch.models import mlp
    from tq_tpu_torch.parallel.sharding import mlp_param_specs, shard_pytree
    from tq_tpu_torch.utils.checkpoint import (load_params_orbax,
                                               save_params_orbax)

    specs = mlp_param_specs()
    params = shard_pytree(mlp.init(torch.Generator().manual_seed(PAR_SEED),
                                   device="cuda"), specs, mesh)
    save_params_orbax(spec["ckpt"], params, mesh=mesh, specs=specs)
    like = {n: {k: torch.zeros_like(v) for k, v in d.items()}
            for n, d in params.items()}
    back = load_params_orbax(spec["ckpt"], like=like, mesh=mesh, specs=specs)
    for n in params:
        for k in params[n]:
            if not torch.equal(back[n][k], params[n][k]):
                fail(f"par checkpoint {n}.{k}: not read back bit for bit")
    return {"fc1_w_shard": list(params["fc1"]["w"].shape), "equal": True}


def par_rank(spec: dict):
    """One rank of group par (world 1 in this process over NCCL, or each
    of two gloo ranks sharing the card): the path's launches counted from
    0 and summed over the ranks, the bytes gloo staged through the host;
    rank 0 returns everything."""
    import torch
    import torch.distributed as dist

    from tq_tpu_torch.parallel import _compat
    from tq_tpu_torch.parallel.mesh import make_mesh
    from tq_tpu_torch.parallel.pp import make_pipeline_mesh

    world = dist.get_world_size()
    for k in _compat.staged:
        _compat.staged[k] = 0
    t0 = time.perf_counter()
    _reset_counts()
    out = {"world": world, "backend": dist.get_backend()}
    model = make_mesh(1, world, device="cuda")
    data = make_mesh(world, 1, device="cuda")
    with _NoPlainOnCard():
        out["transformer"] = _par_transformer(torch, spec, model)
        out["serving"] = _par_serving(torch, spec, data)
        if world > 1:
            out["tp_max_abs_err"] = _par_tp(torch, model)
            out["pipeline"] = _par_pipeline(
                torch, make_pipeline_mesh(world, device="cuda"))
            out["train"] = {"data2": _par_train(torch, data),
                            "model2": _par_train(torch, model)}
            out["checkpoint"] = _par_checkpoint(torch, spec, model)
    torch.cuda.synchronize()
    mine = (_read_counts(), dict(_compat.staged))
    everyone = [None] * world
    dist.all_gather_object(everyone, mine)
    out["launches"] = _sum_counts(*[c for c, _ in everyone])
    out["staged"] = {k: sum(s[k] for _, s in everyone)
                     for k in _compat.staged}
    out["seconds"] = time.perf_counter() - t0
    return out if dist.get_rank() == 0 else None


def _nccl_pair() -> str:
    """Two NCCL ranks on one card: an all-reduce (run by launch.run)."""
    import torch
    import torch.distributed as dist

    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return f"all_reduce gave {t.tolist()}"


def phase_par(torch, smi: str, tmp: Path) -> dict:
    """Group par: the port's parallel/ driven at world 1 (NCCL, here) and
    world 2 (gloo, two ranks on the one card), world 2 held against world
    1 (see par_rank); then what NCCL says to two ranks on one card."""
    import torch.distributed as dist

    from tq_tpu_torch.parallel import launch

    spec = {"tfm_ckpt": str(tmp / "transformer_seeded.npz"),
            "lstm_ckpt": str(tmp / "lstm_seeded.npz"),
            "ckpt": str(tmp / "tp_mlp_ckpt")}
    transformer_checkpoint(spec["tfm_ckpt"])
    lstm_checkpoint(spec["lstm_ckpt"])

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'rdv1'}",
                            rank=0, world_size=1)
    try:
        w1 = par_rank(spec)
    finally:
        dist.destroy_process_group()
    w1_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    w2 = launch.run(par_rank, 2, args=(spec,), backend="gloo", timeout=900)
    w2_seconds = time.perf_counter() - t0

    # World 2 (decoder shards of 16,639 columns) against world 1.
    tfm = {}
    for branch in ("raw", "quantized"):
        a, b = w1["transformer"][branch], w2["transformer"][branch]
        errs = {}
        for key in ("logp", "prompt_logp"):
            want = torch.from_numpy(a[key])
            errs[key] = _par_close(torch.from_numpy(b[key]), want, 1e-5,
                                   f"par transformer {branch} {key}: world "
                                   "2 vs world 1")
        tfm[branch] = {"max_abs_err_vs_world1": errs,
                       "decoder_shard": b["decoder_shard"],
                       "unsharded_decoder": a["decoder_shard"],
                       "tokens_per_s_world1":
                           a["tokens_per_s_one_shared_card"],
                       "tokens_per_s_world2_one_shared_card":
                           b["tokens_per_s_one_shared_card"]}
    s1, s2 = w1["serving"], w2["serving"]
    flipped = (s1["codes"] != s2["codes"]).any(axis=1)
    keep = ~flipped
    if not keep.any():
        fail("par serving: every request's quantized inputs flipped")
    if not (s1["tokens"][keep] == s2["tokens"][keep]).all():
        fail("par serving: tokens differ on rows without a boundary flip")
    lp_err = float(np.abs(s1["logp"][keep] - s2["logp"][keep]).max())
    if lp_err > 1e-4:
        fail(f"par serving: log-probs differ by {lp_err} world 2 vs 1")
    if not (np.isfinite(s1["logp"]).all() and np.isfinite(s2["logp"]).all()):
        fail("par serving: log-probs not finite")

    launches = _sum_counts(w1["launches"], w2["launches"])
    _require_launched(launches, [
        "term_matmul_kernel_mma", "term_matmul_kernel_mma_lp",
        "term_matmul_kernel_stream", "tr_quantize_elementwise",
        "tr_quantize_grouped"], "par")

    try:
        nccl_pair = launch.run(_nccl_pair, 2, backend="nccl",
                               timeout=120)
    except (RuntimeError, TimeoutError) as e:
        said = dict.fromkeys(  # NCCL's own lines, each once, in order
            ln.strip() for ln in str(e).splitlines()
            if "NCCL" in ln or "Duplicate" in ln or "ncclInvalid" in ln)
        nccl_pair = "refused: " + " | ".join(said)
    emit({"phase": "par", "ok": True, "nvidia_smi": smi,
          "note": "world 2 is two processes sharing one card over gloo: "
                  "no multi-GPU run; tokens/s are not a scaling figure",
          "world1": {"backend": w1["backend"], "seconds": w1_seconds,
                     "path_seconds": w1["seconds"]},
          "world2": {"backend": w2["backend"], "seconds": w2_seconds,
                     "path_seconds": w2["seconds"],
                     "gloo_staged_bytes": w2["staged"]},
          "transformer": tfm,
          "serving": {"requests": PAR_REQUESTS, "batch": PAR_BATCH,
                      "words": PAR_WORDS,
                      "rows_with_boundary_flip": int(flipped.sum()),
                      "logp_max_abs_err_vs_world1": lp_err,
                      "tokens_per_s_world1":
                          s1["tokens_per_s_one_shared_card"],
                      "tokens_per_s_world2_one_shared_card":
                          s2["tokens_per_s_one_shared_card"]},
          "tp_max_abs_err": w2["tp_max_abs_err"],
          "pipeline": w2["pipeline"], "train": w2["train"],
          "checkpoint": w2["checkpoint"],
          "launches_world1": {k: v for k, v in w1["launches"].items() if v},
          "launches_world2": {k: v for k, v in w2["launches"].items() if v},
          "nccl_two_ranks_one_card": nccl_pair})
    return launches


def phase_par_cells(torch, smi: str) -> dict:
    """The decoder's shard shapes timed here alone (not in ranks sharing
    the card): mma in f32_raw_packed8 and mma_lp in bf16_packed8 at (350,
    650, 16639) beside the unsharded (350, 650, 33278), by CUDA-graph
    replay, beside torch.matmul on the decoded weights (float32, TF32 off;
    bfloat16 for the bf16 mode), the plain version and the bound (the
    f32 mode on the pack: two TF32 products)."""
    from tq_tpu_torch.kernels.term_matmul import (launch, term_matmul,
                                                  term_matmul_ref)
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize_int_ref

    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    cells = {"term_matmul_kernel_mma": {}, "term_matmul_kernel_mma_lp": {}}
    for M, K, N in PAR_TIMED:
        wp, _, wv = _tm_weights(torch, "packed8", K, N, gen, "cuda")
        x = torch.randn(M, K, generator=gen, device="cuda")
        sf = torch.tensor(0.03, device="cuda")
        nbytes = 4 * M * K + _weight_bytes("packed8", K, N) + 4 * M * N
        for row, variant, kw, peak, products in (
                ("term_matmul_kernel_mma", "f32_raw_packed8",
                 dict(quantize_x=False), PEAK_OPS_PER_S["tf32"], 2),
                ("term_matmul_kernel_mma_lp", "bf16_packed8",
                 dict(bf16=True), PEAK_OPS_PER_S["bf16"], 1)):
            kernel = row.removeprefix("term_matmul_kernel_")
            before = term_matmul.kernel_launches[kernel]
            out = term_matmul(x, wp, sf, 8, 3, **kw)
            ref = term_matmul_ref(x, wp, sf, 8, 3, **kw)
            torch.cuda.synchronize()
            if term_matmul.kernel_launches[kernel] != before + 1:
                fail(f"par cell {variant} {(M, K, N)} did not take {kernel}")
            err = _par_close(out, ref, 1e-5, f"par cell {variant} "
                                             f"{(M, K, N)}")
            w_dec = wv * wp.w_sf
            if kw.get("bf16"):
                a = tr_quantize_int_ref(x, sf, 8, 3).to(torch.bfloat16)
                b = wv.to(torch.bfloat16)
            else:
                a, b = x, w_dec
            bnd, by = bound_ms(nbytes, products * 2 * M * K * N, peak)
            t = timings(torch, lambda: launch(x, wp, sf, 8, 3, **kw),
                        lambda: term_matmul_ref(x, wp, sf, 8, 3, **kw),
                        lambda: torch.matmul(a, b))
            cells[row][f"{variant} {M}x{K}x{N}"] = dict(
                max_abs_err=err, **t, bound_ms=bnd, bound_by=by,
                products=products, card=smi)
            del out, ref, a, b
        del wp, wv, x
        torch.cuda.empty_cache()
    emit({"phase": "par_cells", "ok": True, "cells": cells, "card": smi})
    return cells


def phase_par_examples() -> dict:
    """The three parallel examples at ``--world 2`` on the card, each in
    its own process (all three started together): each prints its JAX
    twin's line."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"tq_tpu_torch.examples.{name}", "--world",
         "2"], cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, _ in PAR_EXAMPLES}
    t0 = time.perf_counter()
    out = {}
    try:
        for name, expect in PAR_EXAMPLES:
            stdout, stderr = procs[name].communicate(timeout=300)
            if procs[name].returncode != 0 or expect not in stdout:
                fail(f"example {name} (--world 2): exit "
                     f"{procs[name].returncode}, stdout {stdout[-800:]!r}, "
                     f"stderr {stderr[-1500:]!r}")
            out[name] = [ln for ln in stdout.splitlines() if ln.strip()][-1]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    emit({"phase": "par_examples", "ok": True, "lines": out,
          "seconds": time.perf_counter() - t0})
    return out


# ------------------------------------------------------- phase par_dryrun
#
# The rest of the JAX package's multi-device dry run on ranks, world 1
# (NCCL, this process) and world 2 (two gloo ranks sharing the card): the
# tensor-parallel CNN forward, the data-parallel CNN eval and the LM rows
# with the batch over 'data'.

DRY_EVAL = dict(batch=64, n_synth=128)   # one setting of the sweep at 224
DRY_TOKENS = (35, 20)                    # the LM chunk: 10 columns a rank
DRY_GREEDY = dict(batch=64, steps=16)
DRY_DECODE = dict(batch=20, steps=16)
DRY_VGG_BATCH = 2
DRY_TIE = 1e-4  # a greedy row whose top two log-probs are this close


def _dry_tp(torch, arch: str, params, x, mesh, world1: bool,
            path: _PathCounts) -> dict:
    """``arch`` TR-converted at the flagship's setting, its conv kernels
    and dense layers over 'model' (``make_tp_cnn_apply``): each converted
    conv within LAYER_RTOL of the unsharded conv on the same input, the
    logits within the CNN rule of the unsharded forward's; one B1 launch a
    converted conv a rank, images/s.  At world 1 also B1 on every recorded
    conv input and B2 on every converted weight bit for bit against their
    plain versions on the CPU.  ``path`` counts the conversion and the
    checked forward only."""
    import dataclasses
    import functools

    from tq_tpu_torch.convert import (convert_cnn, make_cnn_apply,
                                      static_conv_layer_settings)
    from tq_tpu_torch.evals.cnn import get_model
    from tq_tpu_torch.kernels.tr_quantize import tr_quantize
    from tq_tpu_torch.layers.qctx import QuantCtx
    from tq_tpu_torch.parallel._compat import axis_size
    from tq_tpu_torch.parallel.sharding import cnn_param_specs, shard_pytree
    from tq_tpu_torch.parallel.tp import TPQuantCtx, make_tp_cnn_apply

    m = get_model(arch)
    f = FLAGSHIP
    settings = static_conv_layer_settings(m.conv_specs(), *f["tr"])
    qp, qc, qs = path(convert_cnn, m, params, settings, f["db"], f["dt"])
    qs = _with_sf(torch, qs, f["sf"])
    tp_qp = shard_pytree(qp, cnn_param_specs(qp), mesh)
    fwd = make_tp_cnn_apply(m, qc, mesh)
    seen = {}

    @dataclasses.dataclass
    class Recorder(TPQuantCtx):
        def conv(self, name, params, x, stride=(1, 1), padding="SAME",
                 groups=1, x_channels=None):
            y = super().conv(name, params, x, stride, padding, groups,
                             x_channels)
            if name in self.cfg:
                seen[name] = (x, y, stride, padding, groups)
            return y

    with torch.no_grad():
        logits, _ = path(fwd, tp_qp, qs, x)
        b1 = path.last["tr_quantize_elementwise"]
        if b1 != len(qc):
            fail(f"par_dryrun TP {arch}: {b1} B1 launches a forward on a "
                 f"rank, {len(qc)} converted convs")
        make_cnn_apply(m, qc, track=False, context=functools.partial(
            Recorder, mesh=mesh))(tp_qp, qs, x)
        ref, _ = make_cnn_apply(m, qc, track=False)(qp, qs, x)
        plain = QuantCtx(cfg=qc, state=qs)
        worst = (0.0, "")
        for name, (xin, y, stride, padding, groups) in seen.items():
            want = plain.conv(name, qp[name], xin, stride, padding, groups)
            err = float((y - want).abs().max() / want.abs().max())
            worst = max(worst, (err, name))
        if worst[0] > LAYER_RTOL:
            fail(f"par_dryrun TP {arch}: {worst[1]} {worst[0]} of max |y| "
                 "from the unsharded conv on the same input")
        rtol = ZOO_LOGIT_RTOL.get(arch, LOGIT_RTOL)
        logit_err = float((logits - ref).abs().max() / ref.abs().max())
        if logit_err > rtol or not bool(torch.isfinite(logits).all()):
            fail(f"par_dryrun TP {arch}: logits {logit_err} of max |logit| "
                 f"from the unsharded forward (limit {rtol})")
        ips = _images_per_s(torch, lambda: fwd(tp_qp, qs, x), x.shape[0],
                            reps=3)
        out = {"conv_max_rel_err": worst[0], "conv_worst": worst[1],
               "logits_rel_err_vs_unsharded": logit_err,
               "b1_launches_a_forward_a_rank": b1,
               "images_per_s_one_shared_card": ips,
               "logits": logits.cpu().numpy(),
               "n_model": axis_size(mesh, "model")}
        if world1:
            for name, (xin, _, _, _, _) in seen.items():
                tr = qc[name]
                got = tr_quantize(xin, qs[name]["sf"], tr.data_bits, 1,
                                  tr.data_terms)
                want = tr_quantize(xin.cpu(), qs[name]["sf"].cpu(),
                                   tr.data_bits, 1, tr.data_terms)
                if not torch.equal(got.cpu(), want):
                    fail(f"par_dryrun B1 at {name}'s input "
                         f"{tuple(xin.shape)}: not bit for bit")
            cpu_qp, _, _ = convert_cnn(
                m, {k: {n: t.cpu() for n, t in v.items()}
                    for k, v in params.items()}, settings, f["db"], f["dt"])
            for name in qc:
                if not torch.equal(qp[name]["w"].cpu(), cpu_qp[name]["w"]):
                    fail(f"par_dryrun B2 on {name}'s weights "
                         f"{tuple(qp[name]['w'].shape)}: not bit for bit")
            out["b1_b2_held"] = len(seen)
    return out


def _dry_eval(torch, params, mesh, spec: dict, world1: bool,
              path: _PathCounts) -> dict:
    """``eval_setting(mesh=)`` at the flagship setting, batch 64, 128
    synthetic images at 224, each labelled by the float model's argmax at
    world 1 (so that the accuracy is not 0): the columns, every layer's
    calibrated histogram and scale, and each image's quantized prediction
    and top-two logit margin, gathered over 'data' in image order.
    ``path`` counts the ``eval_setting`` call only."""
    from tq_tpu_torch.evals import cnn
    from tq_tpu_torch.layers.qctx import fp32_ctx
    from tq_tpu_torch.models import resnet
    from tq_tpu_torch.parallel._compat import all_gather

    batches = list(cnn._batches("resnet18", None, DRY_EVAL["batch"],
                                DRY_EVAL["n_synth"]))
    if world1:
        with torch.no_grad():
            labels = [resnet.apply(params, torch.as_tensor(x, device="cuda"),
                                   fp32_ctx()).argmax(-1).cpu().numpy()
                      for x, _ in batches]
        np.save(spec["w1_labels"], np.stack(labels))
    labels = np.load(spec["w1_labels"])
    calibrated, logits = [], []
    finalize, make_apply, synth = (cnn.finalize_cnn, cnn.make_cnn_apply,
                                   cnn._batches)

    def recording(qstate, qcfg):
        calibrated.append(finalize(qstate, qcfg))
        return calibrated[-1]

    def recording_apply(m, qcfg, track, **kw):
        fwd = make_apply(m, qcfg, track, **kw)
        if track:
            return fwd

        def run(*args):
            out = fwd(*args)
            logits.append(out[0])
            return out
        return run

    cnn.finalize_cnn, cnn.make_cnn_apply = recording, recording_apply
    cnn._batches = lambda *a: ((x, y) for (x, _), y in zip(batches, labels))
    try:
        wb, gs, wt = FLAGSHIP["tr"]
        cols = path(cnn.eval_setting, resnet, params, wb, gs, wt,
                    FLAGSHIP["db"], FLAGSHIP["dt"], arch="resnet18",
                    batch_size=DRY_EVAL["batch"],
                    n_synth=DRY_EVAL["n_synth"], mesh=mesh)
    finally:
        cnn.finalize_cnn, cnn.make_cnn_apply, cnn._batches = (
            finalize, make_apply, synth)
    # Every batch here is split over 'data' (64 rows a batch): gathered a
    # batch at a time, the rows come back in image order.
    every = torch.cat([all_gather(t, mesh, "data") for t in logits])
    top = every.topk(2, dim=-1)
    return {"columns": list(cols),
            "labels": labels.reshape(-1),
            "pred": top.indices[:, 0].cpu().numpy(),
            "margin": (top.values[:, 0] - top.values[:, 1]).cpu().numpy(),
            "max_logit": float(every.abs().max()),
            "hist": {k: v["hist"].cpu().numpy()
                     for k, v in calibrated[-1].items()},
            "sf": {k: float(v["sf"]) for k, v in calibrated[-1].items()}}


def _dry_train(torch, spec: dict, mesh, world1: bool,
               path: _PathCounts) -> dict:
    """One Transformer chunk at full width, tokens (35, 20) over 'data',
    dropout 0, lr 20, clip 0.25 (``_train_step_transformer(mesh=)``):
    world 1 saves its parameters, world 2's rank 0 holds its own against
    them within rtol 1e-4."""
    import torch.distributed as dist

    from tq_tpu_torch.evals.train_lstm import _train_step_transformer
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    params = params_from_jax(load_params(spec["tfm_ckpt"]), "cuda")
    rng = np.random.default_rng(GEN_SEED)
    T, B = DRY_TOKENS
    toks = torch.as_tensor(rng.integers(0, VOCAB, (T, B)), device="cuda")
    targets = torch.as_tensor(rng.integers(0, VOCAB, (T * B,)),
                              device="cuda")
    loss = path(_train_step_transformer, params, toks, targets, None, 20.0,
                0.25, dropout=0.0, nhead=TFM_NHEAD, mesh=mesh)
    out = {"loss": float(loss)}
    if world1:
        torch.save(params, spec["w1_train"])
    elif dist.get_rank() == 0:
        want = torch.load(spec["w1_train"], map_location="cuda")
        worst = 0.0
        with torch.no_grad():
            for name, leaves in want.items():
                for leaf, w in leaves.items():
                    got = params[name][leaf]
                    err = float((got - w).abs().max())
                    worst = max(worst, err)
                    if not torch.allclose(got, w, rtol=1e-4, atol=1e-7):
                        fail(f"par_dryrun train {name}.{leaf}: max |diff| "
                             f"{err} from world 1")
        out["params_max_abs_err_vs_world1"] = worst
    return out


def _dry_gru(torch, spec: dict, mesh, world1: bool,
             path: _PathCounts) -> dict:
    """The GRU LM at 650/650/33278 (seeded init), packed u8s as the LSTM's
    serving path packs it: one quantized eval chunk at tokens (35, 20)
    over 'data' (world 1 saves its log-probs, each world-2 rank holds its
    columns against them), then 16 greedy steps at batch 64, each rank
    its columns (tokens, chosen log-probs and the quantized inputs'
    fingerprints gathered)."""
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.parallel._compat import all_gather, axis_index
    from tq_tpu_torch.parallel.sharding import shard_batch

    params = lstm_lm.init(torch.Generator().manual_seed(PAR_SEED),
                          cell="GRU", device="cuda")
    qp, qc, qs = path(lstm_lm.convert, params, 8, 8, 24, 8, 8, cell="GRU")
    qs = _with_sf(torch, qs, PAR_LSTM_SF)
    qpk = path(lstm_lm.pack, qp, qc, fmt="u8s", rnn=True)
    fwd = lstm_lm.make_quantized_apply(qc, track=False)
    H = params["rnn"][0]["w_hh"].shape[0]
    rng = np.random.default_rng(GEN_SEED + 1)
    T, B = DRY_TOKENS
    toks = shard_batch(rng.integers(0, VOCAB, (T, B)), mesh, axis=1)
    out = {}
    with torch.no_grad():
        hidden = lstm_lm.init_hidden(toks.shape[1], nhid=H, cell="GRU",
                                     device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logp, _, _ = path(fwd, qpk, qs, toks, hidden)
        torch.cuda.synchronize()
        out["eval_seconds"] = time.perf_counter() - t0
        logp = logp.reshape(T, toks.shape[1], -1)
        if not bool(torch.isfinite(logp).all()):
            fail("par_dryrun GRU eval: log-probs not finite")
        if world1:
            torch.save(logp, spec["w1_gru"])
        else:
            # The chunk quantizes the embeddings and the zero initial state
            # only, the same in both worlds: no row can flip.
            n = toks.shape[1]
            me = axis_index(mesh, "data")
            want = torch.load(spec["w1_gru"], map_location="cuda")
            want = want[:, me * n:(me + 1) * n]
            out["eval_logp_max_abs_err_vs_world1"] = float(
                (logp - want).abs().max())
            if out["eval_logp_max_abs_err_vs_world1"] > 1e-4:
                fail("par_dryrun GRU eval: log-probs "
                     f"{out['eval_logp_max_abs_err_vs_world1']} from world 1")
        Bg = DRY_GREEDY["batch"]
        tok = shard_batch(rng.integers(0, VOCAB, (1, Bg)), mesh, axis=1)
        hidden = lstm_lm.init_hidden(tok.shape[1], nhid=H, cell="GRU",
                                     device="cuda")
        toks_out, lps, fps = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DRY_GREEDY["steps"]):
            fps.append(_par_codes(torch, qpk, qs, qc["rnn"], tok, (hidden,)))
            logp, hidden, _ = path(fwd, qpk, qs, tok, hidden)
            nxt = logp.argmax(-1)
            lps.append(logp.gather(1, nxt[:, None])[:, 0])
            toks_out.append(nxt)
            tok = nxt[None, :]
        torch.cuda.synchronize()
        out["greedy_tokens_per_s_one_shared_card"] = (
            DRY_GREEDY["steps"] * tok.shape[1] / (time.perf_counter() - t0))
        for key, rows in (("tokens", toks_out), ("logp", lps),
                          ("codes", fps)):
            out[key] = all_gather(torch.stack(rows), mesh, "data",
                                  axis=1).T.cpu().numpy()
    return out


def _dry_decode(torch, spec: dict, mesh, path: _PathCounts) -> dict:
    """The Transformer's KV-cache decode at full width, u8s (the dry run's
    raw-input conversion), batch 20 over 'data', 16 greedy steps: tokens
    and each step's top-two log-prob margin, gathered."""
    from tq_tpu_torch.models import transformer_lm as tl
    from tq_tpu_torch.parallel._compat import all_gather
    from tq_tpu_torch.parallel.sharding import shard_batch
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    params = params_from_jax(load_params(spec["tfm_ckpt"]), "cuda")
    qp, qc, qs = path(tl.convert, params, 8, 8, 24, 8, 8)
    qs = _with_sf(torch, qs, PAR_SF)
    qp = path(tl.pack, qp, qc, fmt="u8s")
    steps = DRY_DECODE["steps"]
    tok = shard_batch(np.random.default_rng(GEN_SEED + 2).integers(
        0, VOCAB, (1, DRY_DECODE["batch"])), mesh, axis=1)
    cache = tl.decode_init_cache(steps + 1, tok.shape[1],
                                 params["encoder"]["w"].shape[1], TFM_NHEAD,
                                 tl._nlayers(params), device="cuda")
    toks, margins = [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for n in range(steps):
            logp, cache = path(tl.decode_step, qp, tok, n, cache,
                               nhead=TFM_NHEAD, qcfg=qc, qstate=qs)
            top = logp.topk(2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            tok = logp.argmax(-1)[None, :]
            toks.append(tok[0])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return {"tokens": all_gather(torch.stack(toks), mesh, "data",
                                 axis=1).T.cpu().numpy(),
            "margins": all_gather(torch.stack(margins), mesh, "data",
                                  axis=1).T.cpu().numpy(),
            "tokens_per_s_one_shared_card": steps * tok.shape[1] / seconds}


def par_dryrun_rank(spec: dict):
    """One rank of phase par_dryrun (world 1 in this process over NCCL, or
    each of two gloo ranks sharing the card): each row's seconds and the
    bytes gloo staged for it, the launches of the path's own calls
    (:class:`_PathCounts`) summed over the ranks; rank 0 returns
    everything."""
    import torch
    import torch.distributed as dist

    from tq_tpu_torch.evals.cnn import get_model
    from tq_tpu_torch.parallel import _compat
    from tq_tpu_torch.parallel.mesh import make_mesh
    from tq_tpu_torch.utils.checkpoint import load_params
    from tq_tpu_torch.utils.params import params_from_jax

    world = dist.get_world_size()
    world1 = world == 1
    model = make_mesh(1, world, device="cuda")
    data = make_mesh(world, 1, device="cuda")
    resnet = params_from_jax(load_params(spec["resnet_ckpt"]), "cuda")
    x = np.random.default_rng(0).normal(
        size=(FLAGSHIP["batch"], FLAGSHIP["image"], FLAGSHIP["image"], 3))
    x = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    path = _PathCounts()
    rows = [("tp_resnet18", lambda: _dry_tp(torch, "resnet18", resnet, x,
                                            model, world1, path)),
            ("dp_eval", lambda: _dry_eval(torch, resnet, data, spec, world1,
                                          path)),
            ("dp_train", lambda: _dry_train(torch, spec, data, world1,
                                            path)),
            ("gru", lambda: _dry_gru(torch, spec, data, world1, path)),
            ("decode", lambda: _dry_decode(torch, spec, data, path))]
    if not world1:
        def vgg():
            params = get_model("vgg16_bn").init(
                torch.Generator().manual_seed(ZOO_SEED), device="cuda")
            xv = torch.as_tensor(np.random.default_rng(1).normal(
                size=(DRY_VGG_BATCH, 224, 224, 3)), dtype=torch.float32,
                device="cuda")
            return _dry_tp(torch, "vgg16_bn", params, xv, model, world1,
                           path)
        rows.insert(1, ("tp_vgg16_bn", vgg))
    for k in _compat.staged:
        _compat.staged[k] = 0
    out = {"world": world, "backend": dist.get_backend(), "seconds": {},
           "staged": {}}
    with _NoPlainOnCard():
        for name, row in rows:
            before = dict(_compat.staged)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = row()
            torch.cuda.synchronize()
            out["seconds"][name] = time.perf_counter() - t0
            out["staged"][name] = {k: _compat.staged[k] - before[k]
                                   for k in before}
            torch.cuda.empty_cache()
    everyone = [None] * world
    dist.all_gather_object(everyone, path.total)
    out["launches"] = _sum_counts(*everyone)
    return out if dist.get_rank() == 0 else None


def _dry_held(torch) -> dict:
    """``term_matmul`` at the decode's shapes (M = 20 at world 1, 10 a
    rank at world 2; f32_raw_packed8 on ``mma``), against its plain
    version on the card."""
    from tq_tpu_torch.kernels.term_matmul import term_matmul, term_matmul_ref

    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    errs = {}
    for M, K, N in ((20, 650, VOCAB), (10, 650, VOCAB), (10, 650, 650)):
        wp, _, _ = _tm_weights(torch, "packed8", K, N, gen, "cuda")
        xm = torch.randn(M, K, generator=gen, device="cuda")
        got = term_matmul(xm, wp, 1.0, 8, 8, quantize_x=False)
        want = term_matmul_ref(xm, wp, 1.0, 8, 8, quantize_x=False)
        errs[f"f32_raw_packed8 {M}x{K}x{N}"] = _par_close(
            got, want, 1e-5, f"par_dryrun term_matmul {(M, K, N)}")
    return errs


def phase_par_dryrun(torch, smi: str, tmp: Path) -> dict:
    """Phase par_dryrun: :func:`par_dryrun_rank` at world 1 (NCCL, here)
    and world 2 (gloo, two ranks on the one card), world 2 held against
    world 1; ``tmp`` holds group par's Transformer checkpoint."""
    import torch.distributed as dist

    from tq_tpu_torch.parallel import launch

    spec = {"tfm_ckpt": str(tmp / "transformer_seeded.npz"),
            "resnet_ckpt": str(tmp / "resnet_seeded.npz"),
            "w1_train": str(tmp / "dryrun_w1_train.pt"),
            "w1_gru": str(tmp / "dryrun_w1_gru.pt"),
            "w1_labels": str(tmp / "dryrun_w1_labels.npy")}
    resnet_checkpoint(spec["resnet_ckpt"])
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'rdv_dry'}",
                            rank=0, world_size=1)
    try:
        w1 = par_dryrun_rank(spec)
    finally:
        dist.destroy_process_group()
    w1_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    w2 = launch.run(par_dryrun_rank, 2, args=(spec,), backend="gloo",
                    timeout=600)
    w2_seconds = time.perf_counter() - t0

    a, b = w1["tp_resnet18"], w2["tp_resnet18"]
    want = torch.from_numpy(a.pop("logits"))
    tp_err = float((torch.from_numpy(b.pop("logits")) - want).abs().max()
                   / want.abs().max())
    if tp_err > LOGIT_RTOL:
        fail(f"par_dryrun TP resnet18: world 2's logits {tp_err} of max "
             "|logit| from world 1's")
    w2["tp_vgg16_bn"].pop("logits")

    e1, e2 = w1["dp_eval"], w2["dp_eval"]
    if e1["columns"][1:] != e2["columns"][1:]:
        fail(f"par_dryrun eval: columns {e2['columns']} at world 2, "
             f"{e1['columns']} at world 1")
    # The accuracy: each world's (from the correct counts, summed over
    # 'data' at world 2) is what its gathered predictions give, and the
    # worlds' predictions differ only on images whose top two logits at
    # world 1 lie within 2 LOGIT_RTOL of max |logit| (a quantized input
    # flipped by another cuDNN algorithm at batch 32 moves the logits by
    # less than LOGIT_RTOL of max |logit|, as the TP rows show).
    n_img = len(e1["labels"])
    correct = {}
    for w, e in (("world1", e1), ("world2", e2)):
        correct[w] = int((e["pred"] == e["labels"]).sum())
        if e["columns"][0] != 100.0 * correct[w] / n_img:
            fail(f"par_dryrun eval: accuracy {e['columns'][0]} at {w}, "
                 f"{correct[w]} of {n_img} predictions right")
    near_tie = e1["margin"] <= 2 * LOGIT_RTOL * e1["max_logit"]
    differ = e1["pred"] != e2["pred"]
    if (differ & ~near_tie).any():
        fail(f"par_dryrun eval: {int((differ & ~near_tie).sum())} "
             "predictions differ from world 1's away from a near-tie")
    moved = {}
    for name, h1 in e1["hist"].items():
        h2 = e2["hist"][name]
        if h1.sum() != h2.sum():
            fail(f"par_dryrun eval {name}: {h2.sum()} counts at world 2, "
                 f"{h1.sum()} at world 1")
        if e1["sf"][name] != e2["sf"][name]:
            fail(f"par_dryrun eval {name}: scale {e2['sf'][name]} at world "
                 f"2, {e1['sf'][name]} at world 1")
        if (h1 != h2).any():  # another cuDNN algorithm at batch 32
            moved[name] = int(np.abs(h1 - h2).sum()) // 2
    eval_out = {"columns_world1": e1["columns"],
                "columns_world2": e2["columns"],
                "correct_world1": correct["world1"],
                "correct_world2": correct["world2"],
                "images": n_img,
                "images_with_near_tie_world1": int(near_tie.sum()),
                "predictions_differing": int(differ.sum()),
                "hist_counts": int(sum(h.sum() for h in e1["hist"].values())),
                "elements_moved_between_bins": moved,
                "scales_equal": True}

    t1, t2 = w1["dp_train"]["loss"], w2["dp_train"]["loss"]
    if abs(t2 - t1) > 1e-5 * abs(t1):
        fail(f"par_dryrun train: loss {t2} at world 2, {t1} at world 1")

    g1, g2 = w1["gru"], w2["gru"]
    flipped = (g1["codes"] != g2["codes"]).any(axis=1)
    keep = ~flipped
    if not keep.any():
        fail("par_dryrun GRU greedy: every row's quantized inputs flipped")
    if not (g1["tokens"][keep] == g2["tokens"][keep]).all():
        fail("par_dryrun GRU greedy: tokens differ on rows without a flip")
    gru_err = float(np.abs(g1["logp"][keep] - g2["logp"][keep]).max())
    if gru_err > 1e-4:
        fail(f"par_dryrun GRU greedy: log-probs {gru_err} from world 1")

    d1, d2 = w1["decode"], w2["decode"]
    tied = ((d1["margins"] <= DRY_TIE) | (d2["margins"] <= DRY_TIE)).any(
        axis=1)
    if not (d1["tokens"][~tied] == d2["tokens"][~tied]).all():
        fail("par_dryrun decode: tokens differ on rows without a near-tie")

    launches = _sum_counts(w1["launches"], w2["launches"])
    _require_launched(launches, ["tr_quantize_elementwise",
                                 "tr_quantize_grouped",
                                 "term_matmul_kernel_mma", "histogram"],
                      "par_dryrun")
    held = _dry_held(torch)
    strip = ("tokens", "logp", "codes", "margins")
    emit({"phase": "par_dryrun", "ok": True, "nvidia_smi": smi,
          "note": "world 2 is two processes sharing one card over gloo: "
                  "no multi-GPU run; rates are not a scaling figure",
          "world1": {"backend": w1["backend"], "seconds": w1_seconds,
                     "row_seconds": w1["seconds"],
                     "tp_resnet18": a},
          "world2": {"backend": w2["backend"], "seconds": w2_seconds,
                     "row_seconds": w2["seconds"],
                     "gloo_staged_bytes": w2["staged"],
                     "tp_resnet18": b, "tp_vgg16_bn": w2["tp_vgg16_bn"]},
          "tp_resnet18_logits_rel_err_world2_vs_world1": tp_err,
          "eval": eval_out,
          "train": {"loss_world1": t1, "loss_world2": t2,
                    **{k: v for k, v in w2["dp_train"].items()
                       if k != "loss"}},
          "gru": {"eval": {k: v for k, v in g2.items()
                           if k not in strip},
                  "eval_seconds_world1": g1["eval_seconds"],
                  "greedy_rows_with_boundary_flip": int(flipped.sum()),
                  "greedy_logp_max_abs_err_vs_world1": gru_err,
                  "greedy_tokens_per_s_world1":
                      g1["greedy_tokens_per_s_one_shared_card"]},
          "decode": {"rows_with_near_tie": int(tied.sum()),
                     "tokens_per_s_world1":
                         d1["tokens_per_s_one_shared_card"],
                     "tokens_per_s_world2_one_shared_card":
                         d2["tokens_per_s_one_shared_card"]},
          "term_matmul_held": held,
          "launches_world1": {k: v for k, v in w1["launches"].items() if v},
          "launches_world2": {k: v for k, v in w2["launches"].items() if v}})
    return launches


# -------------------------------------------------------------- group calib


def _histogram_edges(torch, dev):
    """Every bin edge of the default range and its float32 neighbour
    below, the range's ends and their neighbours outside, NaN, +-inf,
    -0.0 and values far out of range."""
    edges = torch.tensor(np.float32(-50.0) + np.arange(8193, dtype=np.float32)
                         * np.float32(100 / 8192), device=dev)
    special = torch.tensor([-50.0, 50.0, -50.000004, 50.000004, 1e9, -1e9,
                            float("nan"), float("inf"), float("-inf"), -0.0,
                            0.0], device=dev)
    return torch.cat([edges, torch.nextafter(edges, edges - 1), special])


def phase_histogram(torch, ckpt: Path):
    """The histogram kernel against its plain version on the card, bit for
    bit: ResNet-18's 20 conv inputs at batch 64 after a ReLU, an all-zero
    (64, 56, 56, 64), the edge cases, an odd-length view one element past
    an aligned address, a strided 1-D view, and 1,024 and 16,384 bins;
    ``histogram_update`` takes the kernel on a float32 CUDA tensor, once a
    tracked layer in a tracked batch of the flagship setting (the path's
    count, with the plain version barred on the card).  Timed (CUDA-graph
    replay) beside the bytes bound, 4 bytes an element."""
    from tq_tpu_torch.convert import (convert_cnn, make_cnn_apply,
                                      static_conv_layer_settings)
    from tq_tpu_torch.evals.cnn import load_params
    from tq_tpu_torch.kernels.histogram import histogram, histogram_ref
    from tq_tpu_torch.layers.quantize import (CalibConfig, histogram_update,
                                              init_histogram)
    from tq_tpu_torch.models import resnet

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    bins, lo, hi = 8192, -50.0, 50.0
    launches0 = histogram.launches["histogram"]
    n_checks = 0

    def held(name, x, num_bins=bins):
        nonlocal n_checks
        got = histogram(x, num_bins, lo, hi)
        _exact(torch, f"histogram {name} bins={num_bins}", got,
               histogram_ref(x, num_bins, lo, hi))
        n_checks += 1

    # The conv inputs, each timed; their sum is a tracked batch's.
    per_conv, batch_ms, elements = {}, 0.0, 0
    for spec in resnet.conv_specs(224):
        shape = (64, spec.out_h * spec.stride, spec.out_w * spec.stride,
                 spec.in_ch)
        x = torch.relu(torch.randn(*shape, generator=gen, device=dev) * 2)
        held(f"{spec.name} {list(shape)}", x)
        ms = device_ms(torch, lambda: histogram(x, bins, lo, hi))
        per_conv[spec.name] = dict(shape=list(shape), ms=ms,
                                   bound_ms=bound_ms(4 * x.numel(), 0)[0])
        batch_ms += ms
        elements += x.numel()
    del x
    shape = RESNET_ACTIVATIONS[0]
    relu = torch.relu(torch.randn(*shape, generator=gen, device=dev) * 2)
    zeros = torch.zeros(shape, device=dev)
    held("all zero", zeros)
    for num_bins in (1024, 16384):
        held("layer1 after ReLU", relu, num_bins)
    edges = _histogram_edges(torch, dev)
    held("edges", edges)
    held("edges 1,024 bins", edges, 1024)
    n = 1_000_003
    big = torch.randn(n + 8, generator=gen, device=dev) * 30
    for off in range(1, 4):  # 4 to 12 bytes past a 16-byte boundary
        held(f"odd length {n} at +{off}", big[off:off + n])
    for m in range(1, 12):   # head and tail alone
        held(f"{m} elements", big[1:1 + m])
    held("strided 1-D view", big[1::3])  # made contiguous first
    cfg = CalibConfig()
    before = histogram.launches["histogram"]
    h = histogram_update(init_histogram(cfg, dev), relu, cfg)
    if histogram.launches["histogram"] != before + 1:
        fail("histogram_update did not launch the histogram kernel on a "
             "float32 CUDA tensor")
    _exact(torch, "histogram_update", h,
           histogram_ref(relu, bins, lo, hi).to(torch.float32))
    # A tracked batch of the flagship setting: one launch a tracked layer.
    _, params = load_params("resnet18", str(ckpt), device="cuda")
    qp, qc, qs = convert_cnn(resnet, params, static_conv_layer_settings(
        resnet.conv_specs(), *FLAGSHIP["tr"]), FLAGSHIP["db"],
        FLAGSHIP["dt"])
    images = torch.randn(8, 224, 224, 3, generator=gen, device=dev)
    checked = histogram.launches["histogram"] - launches0
    _reset_counts()  # the path's count: the tracked batch alone
    with _NoPlainOnCard():
        _, qs = make_cnn_apply(resnet, qc, track=True)(qp, qs, images)
    launches = _read_counts()
    tracked_launches = launches["histogram"]
    if tracked_launches != len(qs):
        fail(f"histogram: {tracked_launches} launches in a tracked batch of "
             f"{len(qs)} tracked layers")

    n = relu.numel()
    b, by = bound_ms(4 * n, 0)
    zero_ms = device_ms(torch, lambda: histogram(zeros, bins, lo, hi))
    row = dict(shape=list(shape), bins=bins, cases=n_checks, max_abs_err=0.0,
               **timings(torch, lambda: histogram(relu, bins, lo, hi),
                         lambda: histogram_ref(relu, bins, lo, hi)),
               bound_ms=b, bound_by=by, all_zero_ms=zero_ms,
               all_zero_plain_ms=device_ms(
                   torch, lambda: histogram_ref(zeros, bins, lo, hi)),
               per_conv=per_conv, tracked_batch_ms=batch_ms,
               tracked_batch_bound_ms=bound_ms(4 * elements, 0)[0],
               tracked_batch_elements=elements)
    if zero_ms > 3 * row["ms"]:
        fail(f"histogram: all-zero input {zero_ms:.4f} ms, more than 3x the "
             f"ReLU input's {row['ms']:.4f}: the hot bin serialises")
    emit({"phase": "histogram", "ok": True, "cases": n_checks,
          "launches": checked + histogram.launches["histogram"],
          "launches_tracked_batch": tracked_launches,
          "results": {"histogram": row}})
    return {"histogram": row}, launches


# The MoE cell's expert layer (benchmark cell moonlight16b-tr-decode-b64):
# 64 experts of width 1,408 over hidden 2,048, 6 a token, batch 64; the
# rows of the crossover sweep between the grouped and per-expert paths.
MOE_EXPERTS, MOE_HIDDEN, MOE_WIDTH, MOE_TOP_K, MOE_SCALE = 64, 2048, 1408, \
    6, 2.446
MOE_ROWS = 64
MOE_SWEEP_ROWS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _moe_layer(torch, gen, dev):
    """A seeded expert layer at the cell's widths: the router (N(0, 0.02),
    bias U(-0.01, 0.01)), each expert's gate, up and down as 9-bit packs
    of random 8-bit grids (scale 1e-4), their grouped tables, and the
    per-expert SwiGLU on the same packs (``term_matmul``, raw input)."""
    import torch.nn.functional as F

    from tq_tpu_torch.kernels.term_matmul import pack_weight_u8s, term_matmul
    from tq_tpu_torch.kernels.term_matmul_grouped import group_weights
    from tq_tpu_torch.layers.moe import Grouped

    sf = torch.tensor(1e-4, device=dev)

    def packs(K, N):
        return [pack_weight_u8s(torch.randint(
            -255, 256, (K, N), generator=gen, device=dev).to(torch.float32)
            * sf, sf, 8, checks=[]) for _ in range(MOE_EXPERTS)]

    gate, up = packs(MOE_HIDDEN, MOE_WIDTH), packs(MOE_HIDDEN, MOE_WIDTH)
    down = packs(MOE_WIDTH, MOE_HIDDEN)
    router = {"w": torch.randn(MOE_EXPERTS, MOE_HIDDEN, generator=gen,
                               device=dev) * 0.02,
              "bias": (torch.rand(MOE_EXPERTS, generator=gen, device=dev)
                       - 0.5) * 0.02}
    grouped = Grouped(group_weights([gate, up], MOE_HIDDEN),
                      group_weights([down], MOE_WIDTH))

    def expert(e, rows):
        g, u = (term_matmul(rows, w[e], 1.0, quantize_x=False)
                for w in (gate, up))
        return term_matmul(F.silu(g) * u, down[e], 1.0, quantize_x=False)

    return router, grouped, expert


def _zipf_rows(torch, gen, dev, rows: int, table: int = 1000):
    """``rows`` hidden rows drawn from ``table`` N(0, 1) rows with Zipf
    (s = 1) ids, as the cell's prompts repeat: the router then loads a few
    experts heavily."""
    weights = 1.0 / torch.arange(1, table + 1, device=dev, dtype=torch.float32)
    ids = torch.multinomial(weights, rows, replacement=True, generator=gen)
    return torch.randn(table, MOE_HIDDEN, generator=gen, device=dev)[ids]


# Kimi-Linear's expert-parallel share (benchmark cell
# kimilinear48b-tr-decode-b256): rank 0 of 4 holds experts 0-63 of a
# 256-way router (top 8, hidden 2,304, width 1,024); a decode step of 256
# rows makes 2,048 pairs.
SHARE_IDS, SHARE_HELD, SHARE_HIDDEN, SHARE_WIDTH, SHARE_TOP_K = 256, 64, \
    2304, 1024, 8
SHARE_ROWS = 256


def _moe_share_case(torch, gen, dev) -> dict:
    """The grouped product on a table of the router's 256 ids with packs
    for the 64 held experts alone, at the Kimi cell's shapes: 256
    Zipf-repeated rows routed by a seeded 256-way router (2,048 pairs),
    gate and up (2,304 -> 1,024) in one launch on the gathered rows, down
    (1,024 -> 2,304) in another, scattered back times the weights; each
    against the plain version on the same inputs (max |err| / max |ref|
    <= 1e-5, the same bound as the full table's), two launches counted;
    ``moe_apply``'s grouped path against its per-expert path with the
    same ``held`` (within 1e-4 of max |y|), free of host syncs; a call
    without ``held``, or with an expert that has no pack, refused.
    Timed: both launches by CUDA-graph replay beside their bytes bound."""
    import torch.nn.functional as F

    from tq_tpu_torch.kernels import term_matmul_grouped as tg
    from tq_tpu_torch.kernels.term_matmul import pack_weight_u8s, term_matmul
    from tq_tpu_torch.layers import moe

    sf = torch.tensor(1e-4, device=dev)
    held = range(SHARE_HELD)

    def packs(K, N):
        return [pack_weight_u8s(torch.randint(
            -255, 256, (K, N), generator=gen, device=dev).to(torch.float32)
            * sf, sf, 8, checks=[]) for _ in held]

    gate, up = (packs(SHARE_HIDDEN, SHARE_WIDTH),
                packs(SHARE_HIDDEN, SHARE_WIDTH))
    down = packs(SHARE_WIDTH, SHARE_HIDDEN)
    absent = [None] * (SHARE_IDS - SHARE_HELD)
    grouped = moe.Grouped(
        tg.group_weights([gate + absent, up + absent], SHARE_HIDDEN),
        tg.group_weights([down + absent], SHARE_WIDTH))
    if grouped.gate_up.stored != tuple(held):
        fail(f"the share's table holds {grouped.gate_up.stored}")
    router = {"w": torch.randn(SHARE_IDS, SHARE_HIDDEN, generator=gen,
                               device=dev) * 0.02,
              "bias": (torch.rand(SHARE_IDS, generator=gen, device=dev)
                       - 0.5) * 0.02}
    weights = 1.0 / torch.arange(1, 1001, device=dev, dtype=torch.float32)
    ids = torch.multinomial(weights, SHARE_ROWS, replacement=True,
                            generator=gen)
    x = torch.randn(1000, SHARE_HIDDEN, generator=gen, device=dev)[ids]
    idx, weight = moe.route(x, router, SHARE_TOP_K, 2.446)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    loads = torch.bincount(flat, minlength=SHARE_IDS)
    ends = torch.cumsum(loads, 0)
    P = order.shape[0]
    first = dict(gather=order, top_k=SHARE_TOP_K)
    second = dict(scatter=order, scale=weight.reshape(-1))
    before = term_matmul.kernel_launches["grouped"]
    gu = tg.term_matmul_grouped(x, ends, grouped.gate_up, held, **first)
    h = F.silu(gu[0]) * gu[1]
    dn = tg.term_matmul_grouped(h, ends, grouped.down, held, **second)
    torch.cuda.synchronize()
    if term_matmul.kernel_launches["grouped"] != before + 2:
        fail("the share's grouped product did not count its two launches")
    errs = {}
    for name, got, want in (
            ("gate_up", gu, tg.term_matmul_grouped_ref(
                x, ends, grouped.gate_up, held, **first)),
            ("down", dn, tg.term_matmul_grouped_ref(
                h, ends, grouped.down, held, **second))):
        errs[name] = float((got - want).abs().max()) / float(
            want.abs().max())
        if not errs[name] <= 1e-5:
            fail(f"term_matmul_grouped share {name}: max |err| / max |ref| "
                 f"{errs[name]}")
    for wrong in (None, range(SHARE_HELD + 1)):
        try:
            tg.term_matmul_grouped(x, ends, grouped.gate_up, wrong, **first)
        except ValueError:
            continue
        fail(f"term_matmul_grouped took held={wrong} on a table of "
             f"{SHARE_HELD} packs")

    def expert(e, rows):
        g, u = (term_matmul(rows, w[e], 1.0, quantize_x=False)
                for w in (gate, up))
        return term_matmul(F.silu(g) * u, down[e], 1.0, quantize_x=False)

    want, _ = moe.moe_apply(x, router, expert, SHARE_TOP_K, 2.446,
                            held=held, layer="smoke.share_per_expert")
    k0 = term_matmul.kernel_launches["grouped"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = moe.moe_apply(x, router, expert, SHARE_TOP_K, 2.446,
                               held=held, layer="smoke.share_grouped",
                               grouped=grouped)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if term_matmul.kernel_launches["grouped"] != k0 + 2:
        fail("the share's grouped path did not take two grouped launches")
    layer_err = float((got - want).abs().max()) / float(want.abs().max())
    if not layer_err <= 1e-4:
        fail(f"moe_apply share grouped against per expert: {layer_err}")
    host_loads = loads.tolist()
    with_rows = sum(1 for e in held if host_loads[e])
    held_pairs = sum(host_loads[e] for e in held)
    gu_bytes = (2 * with_rows * SHARE_HIDDEN * SHARE_WIDTH * 9 / 8
                + SHARE_ROWS * SHARE_HIDDEN * 4 + 2 * P * SHARE_WIDTH * 4)
    dn_bytes = (with_rows * SHARE_WIDTH * SHARE_HIDDEN * 9 / 8
                + P * SHARE_WIDTH * 4 + P * SHARE_HIDDEN * 4)
    return dict(
        shape=[P, SHARE_HIDDEN, SHARE_WIDTH], ids=SHARE_IDS,
        held=SHARE_HELD, held_with_rows=with_rows, held_pairs=held_pairs,
        errs=errs, layer_err=layer_err,
        gate_up_ms=device_ms(torch, lambda: tg.term_matmul_grouped(
            x, ends, grouped.gate_up, held, **first)),
        down_ms=device_ms(torch, lambda: tg.term_matmul_grouped(
            h, ends, grouped.down, held, **second)),
        gate_up_bound_ms=bound_ms(gu_bytes, 0)[0],
        down_bound_ms=bound_ms(dn_bytes, 0)[0])


def phase_moe_grouped(torch):
    """The grouped expert product (``kernels/term_matmul_grouped.py``) at
    the MoE cell's decode shapes: 64 rows routed by a seeded router over
    Zipf-repeated hidden rows (384 pairs), gate and up (2,048 -> 1,408) in
    one launch on the rows gathered by the sort and down (1,408 -> 2,048)
    in another on silu(gate) * up, scattered back times the weights,
    each against the plain version (max |err| / max |ref| <= 1e-5), also
    with half the experts held and at one row (6 pairs, K split over
    clusters); the layer's grouped path against its per-expert path
    (``moe_apply``, within 1e-4 of max |y|: the per-expert path takes
    mma's 2xTF32 sums past 8 rows) with the per-expert launches it
    replaces counted, and the grouped path under
    ``torch.cuda.set_sync_debug_mode("error")`` (no call of it
    synchronizes with the host).  Timed: each launch by CUDA-graph replay
    beside its bytes bound (each expert with pairs read once, 1.125 bytes
    a weight; x in, the outputs out), the per-expert products' device
    time on the same slices, and a layer call's host-clock time on both
    paths at 64 to 8,192 rows (the crossover that ``GROUPED_MAX_PAIRS``
    records; 8,192 rows are a prefill chunk).  Then an expert-parallel
    share at the Kimi cell's shapes (:func:`_moe_share_case`)."""
    import torch.nn.functional as F

    from tq_tpu_torch.kernels import term_matmul_grouped as tg
    from tq_tpu_torch.kernels.term_matmul import term_matmul
    from tq_tpu_torch.layers import moe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    router, grouped, expert = _moe_layer(torch, gen, dev)
    x = _zipf_rows(torch, gen, dev, MOE_ROWS)

    def sort(rows):
        idx, weight = moe.route(rows, router, MOE_TOP_K, MOE_SCALE)
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        loads = torch.bincount(flat, minlength=MOE_EXPERTS)
        return order, torch.cumsum(loads, 0), loads, flat[order], \
            weight.reshape(-1)

    def held_err(got, want, rows=None):
        if rows is not None:
            got, want = got[:, rows], want[:, rows]
        return float((got - want).abs().max()) / float(want.abs().max())

    # The layer's two launches: gate and up on the rows gathered by the
    # sort, down on silu(gate) * up, scattered back times the weights.
    order, ends, loads, expert_of, weight = sort(x)
    P = order.shape[0]
    first = dict(gather=order, top_k=MOE_TOP_K)
    second = dict(scatter=order, scale=weight)
    before = term_matmul.kernel_launches["grouped"]
    gu = tg.term_matmul_grouped(x, ends, grouped.gate_up, **first)
    h = F.silu(gu[0]) * gu[1]
    dn = tg.term_matmul_grouped(h, ends, grouped.down, **second)
    torch.cuda.synchronize()
    if term_matmul.kernel_launches["grouped"] != before + 2:
        fail("term_matmul_grouped did not count its two launches")
    errs = {"gate_up": held_err(gu, tg.term_matmul_grouped_ref(
                x, ends, grouped.gate_up, **first)),
            "down": held_err(dn, tg.term_matmul_grouped_ref(
                h, ends, grouped.down, **second))}
    half = range(0, MOE_EXPERTS, 2)
    errs["held_half"] = held_err(
        tg.term_matmul_grouped(h, ends, grouped.down, half, **second),
        tg.term_matmul_grouped_ref(h, ends, grouped.down, half, **second),
        (expert_of % 2 == 0).nonzero()[:, 0])
    order1, ends1, _, _, _ = sort(x[:1])
    p1 = tg.plan(order1.shape[0], MOE_EXPERTS, MOE_WIDTH, MOE_HIDDEN, 2,
                 torch.cuda.get_device_properties(0).multi_processor_count)
    errs["one_row_split"] = held_err(
        tg.term_matmul_grouped(x, ends1, grouped.gate_up, gather=order1,
                               top_k=MOE_TOP_K),
        tg.term_matmul_grouped_ref(x, ends1, grouped.gate_up, gather=order1,
                                   top_k=MOE_TOP_K))
    for name, err in errs.items():
        if not err <= 1e-5:
            fail(f"term_matmul_grouped {name}: max |err| / max |ref| {err}")
    # The layer: grouped path against the per-expert path.
    k0 = dict(term_matmul.kernel_launches)
    want, _ = moe.moe_apply(x, router, expert, MOE_TOP_K, MOE_SCALE,
                            layer="smoke.per_expert")
    replaced = {k: term_matmul.kernel_launches[k] - k0[k]
                for k in ("stream", "mma")}
    k0 = dict(term_matmul.kernel_launches)
    got, _ = moe.moe_apply(x, router, expert, MOE_TOP_K, MOE_SCALE,
                           layer="smoke.grouped", grouped=grouped)
    torch.cuda.synchronize()
    if (term_matmul.kernel_launches["grouped"] != k0["grouped"] + 2
            or term_matmul.kernel_launches["stream"] != k0["stream"]
            or term_matmul.kernel_launches["mma"] != k0["mma"]):
        fail("the grouped path did not take two grouped launches alone")
    layer_err = float((got - want).abs().max()) / float(want.abs().max())
    if not layer_err <= 1e-4:
        fail(f"moe_apply grouped against per expert: {layer_err}")
    counts = moe.moe_apply.counts["smoke.grouped"]
    if counts["grouped"] != 1 or counts["tokens"] != P:
        fail(f"moe_apply.counts of the grouped call: {counts}")
    # The grouped path makes no host sync: a synchronizing call raises.
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_apply(x, router, expert, MOE_TOP_K, MOE_SCALE,
                      layer="smoke.no_sync", grouped=grouped)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    # Times: each launch, the per-expert products on the same slices.
    gu_ms = device_ms(torch, lambda: tg.term_matmul_grouped(
        x, ends, grouped.gate_up, **first))
    dn_ms = device_ms(torch, lambda: tg.term_matmul_grouped(
        h, ends, grouped.down, **second))
    host_loads = loads.tolist()
    starts = np.concatenate([[0], np.cumsum(host_loads)]).tolist()
    xs = x.index_select(0, order // MOE_TOP_K)

    def per_expert():
        for e, n in enumerate(host_loads):
            if n:
                expert(e, xs[starts[e]:starts[e + 1]])

    per_expert_ms = device_ms(torch, per_expert, calls=2, replays=5)
    with_rows = sum(1 for n in host_loads if n)
    tiles = sum(-(-n // tg.TILE) for n in host_loads)
    # Each byte once: the 64 rows in (gathered a pair at a time), gate and
    # up out; silu(gate) * up in, down out.
    gu_bytes = (2 * with_rows * MOE_HIDDEN * MOE_WIDTH * 9 / 8
                + MOE_ROWS * MOE_HIDDEN * 4 + 2 * P * MOE_WIDTH * 4)
    dn_bytes = (with_rows * MOE_WIDTH * MOE_HIDDEN * 9 / 8
                + P * MOE_WIDTH * 4 + P * MOE_HIDDEN * 4)
    flops = 3 * 2.0 * P * MOE_HIDDEN * MOE_WIDTH
    bound, by = bound_ms(gu_bytes + dn_bytes, flops)

    def layer(rows, grouped_path):
        return lambda: moe.moe_apply(rows, router, expert, MOE_TOP_K,
                                     MOE_SCALE, layer="smoke.sweep",
                                     grouped=grouped if grouped_path
                                     else None)

    # The crossover: a layer call's host-clock time on both paths (each
    # call ends with the device's work; the per-expert path syncs itself).
    sweep, saved = [], moe.GROUPED_MAX_PAIRS
    moe.GROUPED_MAX_PAIRS = 1 << 30
    try:
        for n in MOE_SWEEP_ROWS:
            rows_n = _zipf_rows(torch, gen, dev, n)
            sweep.append(dict(
                rows=n, pairs=n * MOE_TOP_K,
                per_expert_ms=eager_ms(torch, layer(rows_n, False),
                                       iters=10, warmup=2),
                grouped_ms=eager_ms(torch, layer(rows_n, True), iters=10,
                                    warmup=2)))
    finally:
        moe.GROUPED_MAX_PAIRS = saved
    row = dict(shape=[P, MOE_HIDDEN, MOE_WIDTH], experts=MOE_EXPERTS,
               experts_with_rows=with_rows, tiles=tiles,
               max_load=max(host_loads), max_abs_err=max(errs.values()),
               errs=errs, layer_err=layer_err,
               ms=gu_ms + dn_ms, gate_up_ms=gu_ms, down_ms=dn_ms,
               eager_ms=eager_ms(torch, lambda: (
                   tg.term_matmul_grouped(x, ends, grouped.gate_up, **first),
                   tg.term_matmul_grouped(h, ends, grouped.down,
                                          **second))),
               plain_ms=eager_ms(torch, lambda: (
                   tg.term_matmul_grouped_ref(x, ends, grouped.gate_up,
                                              **first),
                   tg.term_matmul_grouped_ref(h, ends, grouped.down,
                                              **second)),
                   iters=5, warmup=1),
               bound_ms=bound, bound_by=by,
               gate_up_bound_ms=bound_ms(gu_bytes, 0)[0],
               down_bound_ms=bound_ms(dn_bytes, 0)[0], library_ms=None,
               per_expert_launches=replaced,
               per_expert_device_ms=per_expert_ms,
               layer_eager_ms={"grouped": sweep[0]["grouped_ms"],
                               "per_expert": sweep[0]["per_expert_ms"]},
               one_row_splits=p1.splits, crossover=sweep,
               kimi_share=_moe_share_case(torch, gen, dev))
    _reset_counts()
    with _NoPlainOnCard():
        moe.moe_apply(x, router, expert, MOE_TOP_K, MOE_SCALE,
                      layer="smoke.path", grouped=grouped)
    torch.cuda.synchronize()
    launches = _read_counts()
    emit({"phase": "moe_grouped", "ok": True,
          "results": {"term_matmul_kernel_grouped": row}})
    return {"term_matmul_kernel_grouped": row}, launches


# ------------------------------------------------------------------ main


GROUPS = ("mlp", "lstm", "cnn", "zoo", "tfm", "train", "leaf", "par",
          "calib", "moe")


def _attach_cells(kernel_results: dict, rows: dict, key: str) -> None:
    """Put a group's per-shape cells under ``key`` of each kernel row; a
    row no earlier group timed (``--only``) is headed by its first
    cell."""
    for name, cells in rows.items():
        row = kernel_results.setdefault(name, {})
        row[key] = cells
        if "ms" not in row:
            head = next(iter(cells.values()))
            row.update(max_abs_err=head.get("max_abs_err", 0.0),
                       library_ms=head.get("library_ms"),
                       **{k: head[k] for k in ("ms", "eager_ms", "plain_ms",
                                               "bound_ms", "bound_by")})


def main(argv=None) -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS,
                    help="run the build and these groups of phases only "
                         "(default: all; the kernels line then lists only "
                         "their rows)")
    args = ap.parse_args(argv)
    groups = set(args.only)

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
    kernel_results, by_path = {}, {}
    if "mlp" in groups:
        kernel_results.update(phase_kernels(torch))
        modes = phase_term_matmul_modes(torch, smi)
        kernel_results["term_matmul_kernel_mma"]["narrow_f32"] = modes.pop(
            "narrow_f32")
        kernel_results.update(modes)
        by_path["mnist_mlp"] = phase_main_path(torch)
        phase_fixed_linear(torch)
    if "lstm" in groups:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "lstm_seeded.npz"
            lstm_checkpoint(ckpt)
            by_path["lstm_sweep"] = phase_lstm_sweep(torch, ckpt)
            by_path["lstm_generation"], tokens = phase_generation(torch,
                                                                  ckpt)
            phase_serving_compare(torch, ckpt, tokens, card, smi)
            by_path["lstm_batch_serving"] = phase_lstm_batch_serving(
                torch, ckpt, smi)
            phase_lstm_graph(torch, ckpt, smi)
    if "cnn" in groups:
        cnn = phase_cnn_kernels(torch)
        for name in ("tr_quantize_elementwise", "tr_quantize_grouped"):
            kernel_results.setdefault(name, {})["resnet_shape"] = cnn[name]
        for name in ("tr_quantize_elementwise_bf16", "tr_scale_copy",
                     "tr_quantize_elementwise_int",
                     "tr_quantize_elementwise_bf16_int"):
            kernel_results[name] = cnn[name]
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "resnet_seeded.npz"
            resnet_checkpoint(ckpt)
            by_path["resnet_flagship"] = phase_flagship(torch, ckpt)
            by_path["resnet_sweep"] = phase_cnn_sweep(torch, ckpt)
    if "zoo" in groups:
        _attach_cells(kernel_results, phase_zoo_kernels(torch), "zoo_shapes")
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "resnet_seeded.npz"
            resnet_checkpoint(ckpt)
            by_path["group_size"] = phase_group_size(torch, ckpt, Path(tmp))
            by_path["cnn_zoo"], int8_cells = phase_cnn_zoo(torch, Path(tmp))
        _attach_cells(kernel_results, int8_cells, "zoo_int8_shapes")
    if "tfm" in groups:
        _attach_cells(kernel_results, phase_tfm_kernels(torch), "tfm_shapes")
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "transformer_seeded.npz"
            transformer_checkpoint(ckpt)
            sweep = phase_tfm_sweep(torch, ckpt)
            gen, served = phase_tfm_generation(torch, ckpt, card, smi)
            by_path["tfm"] = _sum_counts(sweep, gen)
            lstm_ckpt = Path(tmp) / "lstm_seeded.npz"
            lstm_checkpoint(lstm_ckpt)
            phase_tfm_export(torch, served, lstm_ckpt,
                             _lstm_inputs(ckpt)[1])
    if "train" in groups:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "mlp_seeded.npz"
            mlp_checkpoint(ckpt)
            _attach_cells(kernel_results, phase_st_kernels(torch, ckpt),
                          "train_shapes")

            def train():
                with _NoPlainOnCard():
                    phase_mlp_train(torch, ckpt)
                    phase_qat(torch, ckpt)
                    phase_lm_train(torch, Path(tmp))

            _, by_path["train"] = _counted(torch, train)
            # run_demo's evaluations run the reference layer
            # (quantize_input=False): plain products, no term_matmul.
            _require_launched(by_path["train"], [
                "tr_quantize_elementwise", "tr_quantize_grouped",
                "histogram"], "train")
    if "leaf" in groups:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "resnet_seeded.npz"
            resnet_checkpoint(ckpt)
            with _NoPlainOnCard():
                leaf = _sum_counts(phase_empirical(torch, ckpt),
                                   phase_config(torch, Path(tmp)),
                                   phase_trace(torch, ckpt, Path(tmp)),
                                   phase_viz(torch, ckpt),
                                   phase_example(torch))
            by_path["leaf"] = leaf
            _require_launched(leaf, ["tr_quantize_elementwise",
                                     "tr_quantize_grouped", "histogram"],
                              "leaf")
        _attach_cells(kernel_results, phase_oracle(torch), "leaf_shapes")
    if "par" in groups:
        with tempfile.TemporaryDirectory() as tmp:
            by_path["par"] = phase_par(torch, smi, Path(tmp))
            by_path["par_dryrun"] = phase_par_dryrun(torch, smi, Path(tmp))
        _attach_cells(kernel_results, phase_par_cells(torch, smi),
                      "par_shapes")
        phase_par_examples()
    if "calib" in groups:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "resnet_seeded.npz"
            resnet_checkpoint(ckpt)
            rows, by_path["calib"] = phase_histogram(torch, ckpt)
            kernel_results.update(rows)
    if "moe" in groups:
        rows, by_path["moe"] = phase_moe_grouped(torch)
        kernel_results.update(rows)

    lines = []
    for name, meta in KERNELS.items():
        r = kernel_results.get(name, {})
        if "ms" not in r:  # a row of a group left out by --only
            continue
        per_path = {p: counts.get(name, 0) for p, counts in by_path.items()}
        lines.append({"on_main_path": True, "name": name, **meta,
                      "launches": sum(per_path.values()),
                      "launches_by_path": per_path,
                      **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "eager_ms")},
                      **{k: r[k] for k in ("cold_ms",
                                           "bound_share_cold", "per_shape",
                                           "resnet_shape", "zoo_shapes",
                                           "zoo_int8_shapes",
                                           "tfm_shapes", "train_shapes",
                                           "leaf_shapes", "par_shapes",
                                           "modes_m_gt_8", "narrow_f32",
                                           "bound_fp32_ms",
                                           "raw_ms", "reveal_share",
                                           "clusters_at_once",
                                           "all_zero_ms", "per_conv",
                                           "tracked_batch_ms",
                                           "tracked_batch_bound_ms",
                                           "per_expert_launches",
                                           "per_expert_device_ms",
                                           "layer_eager_ms", "crossover")
                         if k in r},
                      "match": True})
    emit({"kernels": lines, "card": smi, "groups": sorted(groups),
          "step_graphs": _graph_counts_now(),
          "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
