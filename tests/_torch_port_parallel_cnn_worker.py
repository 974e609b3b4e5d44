"""Rank functions of ``tests/test_torch_port_parallel_cnn.py``: the rows
of the JAX package's multi-device dry run that the port runs on ranks
since its tensor-parallel CNN forward, its data-parallel CNN eval and its
data-parallel LM steps.

The test starts gloo ranks on the CPU with
``tq_tpu_torch.parallel.launch.run`` once per world size; rank 0 returns
numpy results, which the test holds against the JAX package (computed in
the pytest process on the same numpy inputs) and against the port's
one-rank calls, which rank 0 also returns.  Imports torch and the port
only (never JAX).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tq_tpu_torch.convert import (convert_cnn, make_cnn_apply,
                                  static_conv_layer_settings)
from tq_tpu_torch.layers.qctx import QuantCtx
from tq_tpu_torch.parallel import _compat
from tq_tpu_torch.parallel.mesh import make_mesh
from tq_tpu_torch.parallel.sharding import (cnn_param_specs, shard_batch,
                                            shard_pytree)
from tq_tpu_torch.parallel.tp import TPQuantCtx, make_tp_cnn_apply
from tq_tpu_torch.utils.params import params_from_jax

CPU = "cpu"


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _with_sf(qstate, sf: float):
    return {k: {**v, "sf": torch.tensor(sf)} for k, v in qstate.items()}


@dataclasses.dataclass
class _Recording(TPQuantCtx):
    """The tensor-parallel context, keeping each converted conv's input,
    arguments and gathered output."""

    record: dict = None

    def conv(self, name, params, x, stride=(1, 1), padding="SAME", groups=1,
             x_channels=None):
        y = super().conv(name, params, x, stride, padding, groups,
                         x_channels)
        if name in self.cfg:
            self.record[name] = (x, y, stride, padding, groups)
        return y


def _tp_forward(m, qp, qc, qs, x: torch.Tensor, mesh) -> dict:
    """The model's TP forward on ``mesh`` (conv kernels and dense layers
    over 'model', the batch over 'data'), gathered; the unsharded port
    forward; and each converted conv against the unsharded conv on the
    same input: max |diff| / max |unsharded|."""
    tp_qp = shard_pytree(qp, cnn_param_specs(qp), mesh)
    xs = shard_batch(x, mesh)
    with torch.no_grad():
        logits, _ = make_tp_cnn_apply(m, qc, mesh)(tp_qp, qs, xs)
        record = {}
        rec_logits, _ = make_cnn_apply(
            m, qc, track=False,
            context=functools.partial(_Recording, mesh=mesh,
                                      record=record))(tp_qp, qs, xs)
        ref, _ = make_cnn_apply(m, qc, track=False)(qp, qs, x)
        plain = QuantCtx(cfg=qc, state=qs)
        errs = {}
        for name, (xin, y, stride, padding, groups) in record.items():
            want = plain.conv(name, qp[name], xin, stride, padding, groups)
            errs[name] = float((y - want).abs().max()
                               / want.abs().max().clamp_min(1e-30))
    first = next(k for k in qp if k in qc)
    return {"logits": _np(_compat.all_gather(logits, mesh, "data")),
            "recorded_equal": bool(torch.equal(logits, rec_logits)),
            "unsharded": _np(ref), "conv_errs": errs,
            "w_shard": tuple(tp_qp[first]["w"].shape),
            "w_whole": tuple(qp[first]["w"].shape)}


def _tp_resnet(inp: dict, mesh) -> dict:
    """TR ResNet-18 at the JAX test's setting (wb 8, g 8, wt 16, db 8,
    dt 4, every scale 0.05) on the JAX init."""
    from tq_tpu_torch.models import resnet

    params = params_from_jax(inp["params"], CPU)
    settings = static_conv_layer_settings(resnet.conv_specs(), 8, 8, 16)
    qp, qc, qs = convert_cnn(resnet, params, settings, 8, 4)
    qs = _with_sf(qs, 0.05)
    out = _tp_forward(resnet, qp, qc, qs, torch.from_numpy(inp["x"]), mesh)
    # Each TP conv on the JAX forward's own input of that layer.
    tp_qp = shard_pytree(qp, cnn_param_specs(qp), mesh)
    ctx = TPQuantCtx(cfg=qc, state=qs, mesh=mesh)
    with torch.no_grad():
        out["jax_layers"] = {
            name: _np(ctx.conv(name, tp_qp[name], torch.from_numpy(x),
                               stride, padding, groups))
            for name, (x, stride, padding, groups)
            in inp["jax_layers"].items()}
    return out


def _tp_zoo(arch: str, image: int, batch: int, mesh) -> dict:
    """A zoo arch's TP forward on a seeded init at the flagship's setting
    (wb 9, g 8, wt 12, db 9, dt 3, scales 0.05): against the unsharded
    one."""
    from tq_tpu_torch.evals.cnn import get_model

    m = get_model(arch)
    params = m.init(torch.Generator().manual_seed(0), device=CPU)
    settings = static_conv_layer_settings(m.conv_specs(), 9, 8, 12)
    qp, qc, qs = convert_cnn(m, params, settings, 9, 3)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(batch, image, image, 3)).astype(np.float32))
    out = _tp_forward(m, qp, qc, _with_sf(qs, 0.05), x, mesh)
    out["grouped"] = sorted(s.name for s in m.conv_specs() if s.groups > 1)
    return out


def _refusal(arch: str, mesh) -> str:
    """The ValueError ``shard_pytree`` raises for ``arch``'s converted
    parameters on ``mesh`` ('' if none)."""
    from tq_tpu_torch.evals.cnn import get_model

    m = get_model(arch)
    params = m.init(torch.Generator().manual_seed(0), device=CPU)
    try:
        shard_pytree(params, cnn_param_specs(params), mesh)
    except ValueError as e:
        return str(e)
    return ""


def _states(qstate) -> dict:
    return {k: (_np(v["hist"]), float(v["sf"])) for k, v in qstate.items()}


def _dp_eval(inp: dict, mesh) -> dict:
    """``eval_setting`` at the flagship setting on the given batches (the
    last one a tail that does not divide over 'data'), on ``mesh`` and,
    on rank 0, on one rank: the columns and every layer's calibrated
    histogram and scale."""
    from tq_tpu_torch.evals import cnn
    from tq_tpu_torch.models import resnet

    batches = inp["batches"]
    calibrated = []
    finalize = cnn.finalize_cnn

    def recording_finalize(qstate, qcfg):
        calibrated.append(finalize(qstate, qcfg))
        return calibrated[-1]

    cnn._batches = lambda *args: iter(batches)
    cnn.finalize_cnn = recording_finalize
    params = params_from_jax(inp["params"], CPU)
    kw = dict(arch="resnet18", batch_size=inp["batch_size"],
              n_synth=inp["n_synth"], calib_pct=inp["calib_pct"])
    out = {"mesh": list(cnn.eval_setting(resnet, params, 9, 8, 12, 9, 3,
                                         mesh=mesh, **kw)),
           "mesh_states": _states(calibrated[-1])}
    if torch.distributed.get_rank() == 0:
        out["one_rank"] = list(cnn.eval_setting(resnet, params, 9, 8, 12, 9,
                                                3, **kw))
        out["one_rank_states"] = _states(calibrated[-1])
    return out


def _flat(tree, prefix: str = "") -> dict:
    """{'a/b/0/c': numpy leaf} of a nested parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _np(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _data_cols(t: torch.Tensor, mesh) -> torch.Tensor:
    return shard_batch(t, mesh, axis=1)


def _gather_cols(t: torch.Tensor, mesh) -> np.ndarray:
    return _np(_compat.all_gather(t, mesh, "data", axis=1))


def _train_rows(inp: dict, mesh) -> dict:
    """One Transformer and one GRU chunk at dropout 0 with the batch over
    'data' (``mesh=``) and on one rank, from the same parameters: losses,
    parameters, the GRU's new hidden state; and the dropout generators of
    the 'data' ranks."""
    from tq_tpu_torch.evals.train_lstm import (_train_step,
                                               _train_step_transformer)
    from tq_tpu_torch.parallel.train import data_generator

    toks = torch.from_numpy(inp["tokens"])
    targets = torch.from_numpy(inp["targets"])
    out = {}
    for where, m in (("mesh", mesh), ("one_rank", None)):
        tp = params_from_jax(inp["transformer"], CPU)
        loss = _train_step_transformer(tp, toks, targets, None, 5.0, 0.25,
                                       dropout=0.0, nhead=2, mesh=m)
        gp = params_from_jax(inp["gru"], CPU)
        hidden = torch.from_numpy(inp["gru_hidden"])
        gloss, new_hidden = _train_step(gp, toks, targets, hidden, None,
                                        5.0, 0.25, dropout=0.0, cell="GRU",
                                        mesh=m)
        out[where] = {"transformer_loss": float(loss),
                      "transformer": _flat(tp), "gru_loss": float(gloss),
                      "gru_hidden": _np(new_hidden), "gru": _flat(gp)}
    # At dropout > 0 each 'data' rank draws masks of its own.
    gen = data_generator(1111, mesh, CPU)
    tp = params_from_jax(inp["transformer"], CPU)
    dropped = _train_step_transformer(tp, toks, targets, gen, 5.0, 0.25,
                                      dropout=0.2, nhead=2, mesh=mesh)
    draws = _compat.all_gather(torch.rand(4, generator=gen)[None], mesh,
                               "data")
    out["dropout"] = {"loss": float(dropped), "draws": _np(draws),
                      "losses": _np(_compat.all_gather(
                          dropped[None], mesh, "data"))}
    return out


def _serving_rows(inp: dict, mesh) -> dict:
    """The GRU's quantized eval, its greedy loop and the Transformer's
    KV-cache decode with the batch over 'data' (each rank its columns, no
    collective), gathered in rank order, beside the one-rank calls."""
    from tq_tpu_torch.models import lstm_lm
    from tq_tpu_torch.models import transformer_lm as tl

    gq, gcfg, gqs = lstm_lm.convert(params_from_jax(inp["gru"], CPU), 8, 8,
                                    24, 8, 8, cell="GRU")
    gqs = _with_sf(gqs, 0.05)
    gfwd = lstm_lm.make_quantized_apply(gcfg, track=False)
    toks = torch.from_numpy(inp["tokens"])
    T, B = toks.shape
    hidden = torch.zeros(inp["gru_hidden"].shape)

    def gru_eval(tok, h):
        logp, h, _ = gfwd(gq, gqs, tok, h)
        return logp.reshape(T, tok.shape[1], -1), h

    def greedy(tok, h, steps: int):
        out = []
        for _ in range(steps):
            logp, h, _ = gfwd(gq, gqs, tok, h)
            tok = logp.reshape(1, tok.shape[1], -1)[-1].argmax(-1)[None]
            out.append(tok[0])
        return torch.stack(out)

    qp, qc, qs = tl.convert(params_from_jax(inp["transformer"], CPU), 8, 8,
                            24, 8, 8)
    qs = _with_sf(qs, 0.05)
    qp = tl.pack(qp, qc, fmt="u8s")

    def decode(tok, L: int):
        cache = tl.decode_init_cache(L, tok.shape[1], 16, 2, 1)
        out = []
        for n in range(L - 1):
            logp, cache = tl.decode_step(qp, tok, n, cache, nhead=2,
                                         qcfg=qc, qstate=qs)
            tok = logp.argmax(-1)[None]
            out.append(tok[0])
        return torch.stack(out)

    tok0 = torch.zeros((1, B), dtype=torch.int32)
    with torch.no_grad():
        logp, h = gru_eval(_data_cols(toks, mesh), _data_cols(hidden, mesh))
        mesh_rows = {"gru_logp": _gather_cols(logp, mesh),
                     "gru_hidden": _gather_cols(h, mesh),
                     "greedy": _gather_cols(greedy(
                         _data_cols(tok0, mesh), _data_cols(hidden, mesh),
                         inp["greedy_steps"]), mesh),
                     "decode": _gather_cols(decode(_data_cols(tok0, mesh),
                                                   inp["cache_len"]), mesh)}
        logp, h = gru_eval(toks, hidden)
        one = {"gru_logp": _np(logp), "gru_hidden": _np(h),
               "greedy": _np(greedy(tok0, hidden, inp["greedy_steps"])),
               "decode": _np(decode(tok0, inp["cache_len"]))}
    return {"mesh": mesh_rows, "one_rank": one,
            "local_batch": int(_data_cols(toks, mesh).shape[1])}


def cnn_world2(inp: dict) -> dict:
    """Every world-2 computation of the test: TP on a (1, 2) mesh, the
    DP eval and the LM rows on (2, 1)."""
    torch.manual_seed(0)
    m12 = make_mesh(1, 2, device=CPU)
    m21 = make_mesh(2, 1, device=CPU)
    return {"tp": _tp_resnet(inp["resnet"], m12),
            "zoo": {arch: _tp_zoo(arch, image, batch, m12)
                    for arch, image, batch in inp["zoo"]},
            "eval": _dp_eval(inp["eval"], m21),
            "train": _train_rows(inp["lm"], m21),
            "serving": _serving_rows(inp["lm"], m21)}


def cnn_world4(inp: dict) -> dict:
    """Every world-4 computation of the test: TP ResNet-18 on a (2, 2)
    mesh; MobileNet-v2 and EfficientNet-b0's refusal on (1, 4)."""
    m22 = make_mesh(2, 2, device=CPU)
    m14 = make_mesh(1, 4, device=CPU)
    return {"tp": _tp_resnet(inp["resnet"], m22),
            "zoo": {"mobilenet_v2": _tp_zoo("mobilenet_v2", 32, 4, m14)},
            "refusal": {"efficientnet_b0": _refusal("efficientnet_b0", m14),
                        "mobilenet_v2": _refusal("mobilenet_v2", m14)}}
