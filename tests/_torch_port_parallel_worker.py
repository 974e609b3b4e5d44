"""Rank functions of the port's parallel tests (``tq_tpu_torch.parallel``).

``tests/test_torch_port_parallel.py`` and ``test_torch_port_pipeline.py``
start gloo ranks on the CPU with ``tq_tpu_torch.parallel.launch.run`` once
per world size and call one function here in each rank; it runs every
port computation of that module and rank 0 returns numpy results, which
the tests hold against the JAX package, computed in the pytest process on
the same numpy inputs.  Imports torch and the port only (never JAX), so
that a rank starts in about a second.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from tq_tpu_torch.kernels.term_matmul import PackedWeight8, term_matmul
from tq_tpu_torch.parallel import _compat
from tq_tpu_torch.parallel.mesh import local_mesh, make_mesh
from tq_tpu_torch.parallel.sharding import (P, mlp_param_specs, shard,
                                            shard_batch, shard_pytree)
from tq_tpu_torch.utils.params import params_from_jax

CPU = "cpu"


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _error(fn) -> str:
    """The message of the ValueError ``fn()`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _weight(spec: dict):
    """A TP case's weight: a tensor or a PackedWeight8 from numpy."""
    if "lo" in spec:
        return PackedWeight8(*(torch.from_numpy(spec[k])
                               for k in ("lo", "signs", "w_sf")))
    return torch.from_numpy(spec["w"])


def _tp_case(case: dict, mesh) -> dict:
    """One tensor-parallel product on ``mesh`` (model axis), gathered,
    and the unsharded port call on the same inputs."""
    from tq_tpu_torch.parallel import tp

    x = torch.from_numpy(case["x"])
    w = _weight(case)
    sf = torch.tensor(case["sf"])
    w_sf = (torch.tensor(case["w_sf_int"]) if case.get("w_sf_int")
            is not None else None)
    kw = dict(int8=case.get("int8", False), bf16=case.get("bf16", False))
    bits, k, fn = case["bits"], case["k"], case["fn"]
    if fn == "col_packed":
        wl = shard_pytree(w, P(None, "model"), mesh)
        y = tp.tp_term_matmul_col_packed(
            x, wl, sf, bits, k, mesh, bf16=case["bf16"],
            quantize_x=case["quantize_x"])
        y = _compat.all_gather(y, mesh, "model", axis=1)
        ref = term_matmul(x, w, sf, bits, k, bf16=case["bf16"],
                          quantize_x=case["quantize_x"])
    else:
        ref = term_matmul(x, w, sf, bits, k, w_sf=w_sf, **kw)
        if fn == "col":
            y = tp.tp_term_matmul_col(x, shard(w, P(None, "model"), mesh), sf,
                                      bits, k, mesh, w_sf=w_sf, **kw)
            y = _compat.all_gather(y, mesh, "model", axis=1)
        elif fn == "row":
            y = tp.tp_term_matmul_row(
                shard(x, P(None, "model"), mesh),
                shard(w, P("model", None), mesh), sf, bits, k, mesh,
                w_sf=w_sf, **kw)
        else:
            y = tp.tp_term_matmul_overlap(
                shard(x, P(None, "model"), mesh),
                shard(w, P(None, "model"), mesh), sf, bits, k, mesh,
                w_sf=w_sf, **kw)
            y = _compat.all_gather(y, mesh, "model", axis=1)
    return {"y": _np(y), "unsharded": _np(ref)}


def _tp_col_exported(case: dict, mesh) -> np.ndarray:
    """The column-parallel product traced by ``torch.export`` (the port's
    counterpart of calling it under ``jax.jit``: its ``term_matmul`` is
    the operator ``tq::term_matmul`` there) and run, gathered."""
    from tq_tpu_torch.parallel import tp

    class Col(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("w", shard(torch.from_numpy(case["w"]),
                                            P(None, "model"), mesh))
            self.register_buffer("sf", torch.tensor(case["sf"]))

        def forward(self, x):
            return tp.tp_term_matmul_col(x, self.w, self.sf, case["bits"],
                                         case["k"], mesh)

    x = torch.from_numpy(case["x"])
    program = torch.export.export(Col(), (x,))
    return _np(_compat.all_gather(program.module()(x), mesh, "model",
                                  axis=1))


def _transformer(inp: dict, mesh) -> dict:
    """The Transformer's TP serving forward against its unsharded one, in
    the raw-input and quantized-input decoders."""
    from tq_tpu_torch.models import transformer_lm as tl

    params = params_from_jax(inp["params"], CPU)
    toks = torch.from_numpy(inp["tokens"])
    out = {}
    for quantized in (False, True):
        qp, qc, qs = tl.convert(params, 8, 8, 24, 8, 8,
                                quantize_input=quantized)
        qs = {k: {**v, "sf": torch.tensor(0.05)} for k, v in qs.items()}
        if not quantized:
            out["unpacked_error"] = ""
            try:
                tl.make_tp_quantized_apply(qc, mesh)(qp, qs, toks)
            except TypeError as e:
                out["unpacked_error"] = str(e)
        qp = tl.pack(qp, qc, fmt="u8s")
        ref, _ = tl.make_quantized_apply(qc, track=False)(qp, qs, toks)
        tp_qp = shard_pytree(qp, tl.tp_param_specs(), mesh)
        got, _ = tl.make_tp_quantized_apply(qc, mesh)(tp_qp, qs, toks)
        key = "quantized" if quantized else "raw"
        out[key] = {"tp": _np(got), "unsharded": _np(ref),
                    "lo_shard": tuple(tp_qp["decoder"]["w"].lo.shape)}
    return out


def _train(inp: dict, mesh) -> dict:
    """One DP x TP step of the MLP at dropout 0 from the given init, the
    single-device port step beside it, and the eval count."""
    from tq_tpu_torch.evals import train_mlp
    from tq_tpu_torch.parallel.train import (make_sharded_eval_step,
                                             make_sharded_train_step)

    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    params = shard_pytree(params_from_jax(inp["params"], CPU),
                          mlp_param_specs(), mesh)
    opt = torch.optim.Adadelta(train_mlp.trainable(params), lr=1.0)
    loss = make_sharded_train_step(opt, mesh)(params, x, y, dropout=False)
    correct = make_sharded_eval_step(mesh)(params, x, y)

    single = params_from_jax(inp["params"], CPU)
    opt1 = torch.optim.Adadelta(train_mlp.trainable(single), lr=1.0)
    loss1 = train_mlp.train_step(single, opt1, x, y, dropout=False)
    gathered = {}
    for name, spec in mlp_param_specs().items():
        for leaf, s in spec.items():
            t = params[name][leaf].detach()
            for axis, dim in enumerate(s):
                if dim is not None:
                    t = _compat.all_gather(t, mesh, dim, axis=axis)
            gathered[f"{name}/{leaf}"] = _np(t)
    return {"loss": float(loss), "single_loss": float(loss1),
            "params": gathered, "correct": int(correct),
            "single_params": {f"{n}/{k}": _np(v) for n, d in single.items()
                              for k, v in d.items()}}


def _checkpoint(inp: dict, mesh, path: str) -> dict:
    """The TP-sharded MLP saved by every rank and read back into zeroed
    shards, and read whole."""
    from tq_tpu_torch.utils.checkpoint import (load_params_orbax,
                                               save_params_orbax)

    specs = mlp_param_specs()
    params = shard_pytree(params_from_jax(inp["params"], CPU), specs, mesh)
    save_params_orbax(path, params, mesh=mesh, specs=specs)
    like = {n: {k: torch.zeros_like(v) for k, v in d.items()}
            for n, d in params.items()}
    back = load_params_orbax(path, like=like, mesh=mesh, specs=specs)
    same = all(torch.equal(back[n][k], params[n][k])
               for n in params for k in params[n])
    whole = load_params_orbax(path)
    return {"shards_equal": same,
            "whole": {f"{n}/{k}": _np(v) for n, d in whole.items()
                      for k, v in d.items()},
            "fc1_w_shard": tuple(params["fc1"]["w"].shape)}


def _checkpoint_packed(case: dict, mesh, path: str) -> dict:
    """A 9-bit pack split over N on 'model' (its planes sharded, its
    scale replicated) saved by every rank, read back into zeroed shards
    and read whole."""
    from tq_tpu_torch.utils.checkpoint import (load_params_orbax,
                                               save_params_orbax)

    specs = {"dec": {"w": P(None, "model")}}
    tree = shard_pytree({"dec": {"w": _weight(case)}}, specs, mesh)
    save_params_orbax(path, tree, mesh=mesh, specs=specs)
    like = {"dec": {"w": PackedWeight8(*(torch.zeros_like(t)
                                         for t in tree["dec"]["w"]))}}
    back = load_params_orbax(path, like=like, mesh=mesh, specs=specs)
    whole = load_params_orbax(path)["dec"]["w"]
    return {"type": type(back["dec"]["w"]).__name__,
            "shards_equal": all(torch.equal(a, b) for a, b in
                                zip(back["dec"]["w"], tree["dec"]["w"])),
            "shard_shapes": [tuple(t.shape) for t in tree["dec"]["w"]],
            "whole_type": type(whole).__name__,
            "whole": {k: _np(getattr(whole, k))
                      for k in ("lo", "signs", "w_sf")}}


def parallel_world2(inp: dict) -> dict:
    """Every world-2 computation of test_torch_port_parallel.py."""
    torch.manual_seed(0)
    m12 = make_mesh(1, 2, device=CPU)
    m21 = make_mesh(2, 1, device=CPU)
    out = {"shapes": {"m12": tuple(m12.shape), "m21": tuple(m21.shape),
                      "local": tuple(local_mesh(device=CPU).shape),
                      "names": tuple(m12.mesh_dim_names)},
           "errors": {"n_model_3": _error(lambda: make_mesh(n_model=3,
                                                            device=CPU)),
                      "too_big": _error(lambda: make_mesh(2, 2,
                                                          device=CPU))}}
    # Placement: this rank's shards of the MLP and of a 9-bit pack.
    params = params_from_jax(inp["mlp"]["params"], CPU)
    sharded = shard_pytree(params, mlp_param_specs(), m12)
    out["placement"] = {f"{n}/{k}": tuple(v.shape)
                        for n, d in sharded.items() for k, v in d.items()}
    out["fc1_w_rank0"] = _np(sharded["fc1"]["w"])
    wp = _weight(inp["tp"]["col_packed_bf16"])
    wl = shard_pytree({"w": wp}, {"w": P(None, "model")}, m12)["w"]
    out["packed_shard"] = [tuple(t.shape) for t in wl]
    out["packed_contiguous"] = all(t.is_contiguous() for t in wl)
    x6 = torch.arange(18.0).reshape(6, 3)
    out["shard_batch"] = {"even": _np(shard_batch(x6, m21)),
                          "tail": _np(shard_batch(x6[:5], m21)),
                          "axis1": _np(shard_batch(x6.T, m21, axis=1))}
    # ppermute: a shift, a rank that receives nothing, its gradient.
    me = _compat.axis_index(m12, "model")
    v = torch.full((3,), float(me + 1), requires_grad=True)
    shifted = _compat.PPermute.apply(v, m12, "model", [(0, 1)])
    (shifted * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    out["ppermute"] = {"value": _np(shifted), "grad": _np(v.grad),
                       "psum": _np(_compat.psum(v.detach(), m12, "model"))}
    out["tp"] = {name: _tp_case(case, m12)
                 for name, case in inp["tp"].items()}
    out["tp_exported"] = _tp_col_exported(inp["tp"]["col_f32"], m12)
    out["transformer"] = _transformer(inp["transformer"], m12)
    # The quantized MLP on a batch sharded over 'data'.
    from tq_tpu_torch.models import mlp

    qp, qc, qs = mlp.convert(params, mlp.static_layer_settings(4, 16, 14),
                             6, 6, True)
    qs = {k: {**v, "sf": torch.tensor(0.05)} for k, v in qs.items()}
    fwd = mlp.make_quantized_apply(qc, track=False)
    xq = torch.from_numpy(inp["mlp"]["xq"])
    logp, _ = fwd(qp, qs, shard_batch(xq, m21))
    out["mlp_under_mesh"] = _np(_compat.all_gather(logp, m21, "data"))
    out["train"] = {"m21": _train(inp["mlp"], m21),
                    "m12": _train(inp["mlp"], m12)}
    out["checkpoint"] = _checkpoint(inp["mlp"], m12, inp["ckpt_path"])
    out["checkpoint_packed"] = _checkpoint_packed(
        inp["tp"]["col_packed_bf16"], m12, inp["ckpt_path"] + "_packed")
    return out


def parallel_world4(inp: dict) -> dict:
    """Every world-4 computation of test_torch_port_parallel.py: the
    (2, 2) mesh, its train step, and the multihost helpers."""
    from tq_tpu_torch.parallel import multihost

    m22 = make_mesh(2, 2, device=CPU)
    out = {"shape": tuple(m22.shape),
           "errors": {"n_model_3": _error(lambda: make_mesh(n_model=3,
                                                            device=CPU)),
                      "global_3": _error(lambda: multihost.global_mesh(
                          n_model=3, device=CPU))},
           "train": _train(inp["mlp"], m22)}
    g = multihost.global_mesh(n_model=2, device=CPU)
    data = _compat.axis_index(g, "data")
    x = inp["batch"]
    rows = x.shape[0] // 2
    local = multihost.host_local_batch(g, x[data * rows:(data + 1) * rows])
    out["global_mesh"] = tuple(g.shape)
    out["host_local_batch"] = _np(_compat.all_gather(local, g, "data"))
    rep = multihost.scaling_report(
        lambda t: torch.tanh(t) @ torch.ones(8, 8),
        lambda: np.ones((8, 8), np.float32), g, iters=3)
    out["scaling_report"] = rep
    return out


def pipeline_world4(inp: dict) -> dict:
    """Every world-4 computation of test_torch_port_pipeline.py: the
    pipeline at several (stage, data) shapes, its gradients, the TR
    block, the MLP pipeline, the mesh's refusals and the BatchRunner."""
    from tq_tpu_torch.models import mlp
    from tq_tpu_torch.parallel.pp import (build_mlp_pipeline,
                                          make_pipeline_mesh,
                                          make_tr_block_fn, pipeline_apply)
    from tq_tpu_torch.parallel.serving import BatchRunner

    def block(p, x):
        return torch.relu(torch.matmul(x, p["w"]) + p["b"])

    def run(case, block_fn, grad=False):
        mesh = make_pipeline_mesh(case["n_stage"], case.get("n_data"),
                                  device=CPU)
        sp = {k: torch.from_numpy(v).requires_grad_(grad)
              for k, v in case["params"].items()}
        x = shard_batch(torch.from_numpy(case["x"]), mesh, axis=1)
        y = pipeline_apply(sp, x, block_fn, mesh)
        res = {"y": _np(_compat.all_gather(y, mesh, "data", axis=1)),
               "mesh": tuple(mesh.shape)}
        if grad:
            (y ** 2).sum().backward()
            res["grads"] = {k: _np(_compat.psum(v.grad, mesh, "stage"))
                            for k, v in sp.items()}
        return res

    out = {"pipeline": {name: run(case, block)
                        for name, case in inp["pipeline"].items()},
           "grads": run(inp["grads"], block, grad=True),
           "tr_block": run(inp["tr_block"], make_tr_block_fn(7, 3))}
    mesh4 = make_pipeline_mesh(4, device=CPU)
    params, forward = build_mlp_pipeline(torch.Generator().manual_seed(0),
                                         n_stage=4, width=32, in_dim=20,
                                         n_classes=10, device=CPU)
    out["mlp_pipeline"] = _np(forward(params, torch.from_numpy(inp["mlp_x"]),
                                      mesh4))
    out["mlp_params"] = {g: {k: _np(v) for k, v in d.items()}
                         for g, d in params.items()}
    seq = torch.from_numpy(inp["mlp_x"])
    h = torch.relu(seq @ params["stem"]["w"] + params["stem"]["b"])
    for s in range(4):
        h = block({k: v[s] for k, v in params["trunk"].items()}, h)
    out["mlp_sequential"] = _np(torch.log_softmax(
        h @ params["head"]["w"] + params["head"]["b"], dim=-1))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        make_pipeline_mesh(2, n_data=1, device=CPU)
    out["mesh_refusals"] = {
        "warning": [str(w.message) for w in caught],
        "not_divisible": _error(lambda: make_pipeline_mesh(3, device=CPU)),
        "too_big": _error(lambda: make_pipeline_mesh(4, n_data=2,
                                                     device=CPU))}

    # The BatchRunner on four data ranks.
    dmesh = local_mesh(device=CPU)
    runner = BatchRunner(lambda x: x.sum(dim=(1, 2)), dmesh, batch_size=16)
    out["serving_sums"] = np.asarray(runner.run_all(inp["serving"]["sums"]))
    out["serving_bad_batch"] = _error(
        lambda: BatchRunner(lambda x: x, dmesh, batch_size=10))
    params = params_from_jax(inp["serving"]["params"], CPU)
    qp, qc, qs = mlp.convert(params, mlp.static_layer_settings(4, 16, 14),
                             6, 6, True)
    qs = {k: {**v, "sf": torch.tensor(0.05)} for k, v in qs.items()}
    fwd = mlp.make_quantized_apply(qc, track=False)
    runner = BatchRunner(lambda x: fwd(qp, qs, x)[0], dmesh, batch_size=32)
    out["serving_mlp"] = np.stack(runner.run_all(inp["serving"]["images"]))
    return out


def fail_on_rank(bad: int):
    """Raise on rank ``bad``; the others wait in a barrier."""
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()


def hang_on_rank(bad: int):
    """Rank ``bad`` never joins the barrier."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == bad:
        time.sleep(3600)
    dist.barrier()
