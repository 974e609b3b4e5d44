"""MNIST MLP workload: 784-512-512-10.

Port of ``tq_tpu.models.mlp``: the fp32 model, TR conversion of every
dense layer and the shape table for the op counter.  Parameters are a dict
``{name: {'w': (in, out), 'b': (out,)}}`` of tensors, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from tq_tpu_torch.layers.common import TRParams, dropout
from tq_tpu_torch.layers.linear import (
    finalize_quant_state,
    init_quant_state,
    tr_dense_apply,
    tr_dense_convert,
)
from tq_tpu_torch.profilers import LayerCost

LAYER_NAMES = ("fc1", "fc2", "fc3")
DIMS = ((784, 512), (512, 512), (512, 10))
DROPOUT = 0.2


def init(generator: torch.Generator, device=None):
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases, as
    ``torch.nn.Linear`` initializes them."""
    params = {}
    for name, (fan_in, fan_out) in zip(LAYER_NAMES, DIMS):
        bound = 1.0 / math.sqrt(fan_in)

        def uniform(*shape):
            u = torch.rand(*shape, generator=generator)
            return ((2 * u - 1) * bound).to(device)

        params[name] = {"w": uniform(fan_in, fan_out), "b": uniform(fan_out)}
    return params


def apply(params, x: torch.Tensor, train: bool = False,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """fp32 forward pass -> log-probabilities.  ``train`` applies dropout
    (:data:`DROPOUT`, masks from ``generator``) after each hidden ReLU."""
    x = x.reshape(x.shape[0], -1)
    for i, name in enumerate(LAYER_NAMES):
        x = torch.matmul(x, params[name]["w"]) + params[name]["b"]
        if i < len(LAYER_NAMES) - 1:
            x = torch.relu(x)
            if train:
                x = dropout(x, DROPOUT, generator)
    return torch.log_softmax(x, dim=-1)


def layer_costs(batch: int = 1) -> list[LayerCost]:
    """Shape table for the term-MAC counter (batch=1 is the reference's
    profile call)."""
    return [LayerCost("dense", name, batch * d_out, d_in,
                      weight_numel=d_in * d_out)
            for name, (d_in, d_out) in zip(LAYER_NAMES, DIMS)]


def static_layer_settings(weight_bits: int, group_size: int,
                          num_terms: int) -> list[tuple[int, int, int]]:
    """The same (weight_bits, group_size, num_terms) for every layer."""
    return [(weight_bits, group_size, num_terms)] * len(LAYER_NAMES)


def convert(params, tr_settings: Sequence[tuple[int, int, int]],
            data_bits: int, data_terms: int, quantize_input: bool = False):
    """TR-convert every dense layer, on the device the weights are on.

    ``quantize_input=False`` reproduces the reference layer, which
    computes but never uses the quantized activations; True gives the
    fixed behaviour.  Returns (qparams, qcfg, qstate).
    """
    qparams, qcfg, qstate = {}, {}, {}
    for name, (wb, gs, wt) in zip(LAYER_NAMES, tr_settings):
        tr = TRParams(weight_bits=wb, group_size=gs, weight_terms=wt,
                      data_bits=data_bits, data_terms=data_terms,
                      quantize_input=quantize_input)
        qparams[name] = tr_dense_convert(params[name], tr)
        qcfg[name] = tr
        qstate[name] = init_quant_state(device=params[name]["w"].device)
    return qparams, qcfg, qstate


def make_quantized_apply(qcfg, track: bool):
    """Two-phase forward of the converted model:
    ``f(qparams, qstate, x) -> (logp, new_qstate)``."""

    def forward(qparams, qstate, x):
        x = x.reshape(x.shape[0], -1)
        new_state = {}
        for i, name in enumerate(LAYER_NAMES):
            x, new_state[name] = tr_dense_apply(
                qparams[name], qcfg[name], qstate[name], x, track)
            if i < len(LAYER_NAMES) - 1:
                x = torch.relu(x)
        return torch.log_softmax(x, dim=-1), new_state

    return forward


def finalize(qstate, qcfg):
    """Run the MSE scale search for every layer."""
    return {name: finalize_quant_state(qstate[name], qcfg[name].data_bits,
                                       qcfg[name].data_terms)
            for name in qstate}
