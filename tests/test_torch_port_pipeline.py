"""The port's GPipe pipeline (``parallel/pp.py``) and continuous-batching
runner (``parallel/serving.py``) against the JAX package.

The port runs in four gloo ranks on the CPU, started once by a
module-scoped fixture (the rank function is
``tests/_torch_port_parallel_worker.py::pipeline_world4``); the JAX
package runs here on the first four of the conftest's virtual devices,
on a mesh of the same shape and the same numpy inputs.  Tolerances: the
pipeline rtol 1e-5, atol 1e-5, forward and gradients, against the JAX
package's pipeline (and its ``build_mlp_pipeline`` forward on the port's
parameters) and the sequential stages; the serving runner as the
JAX tests' (sums rtol 1e-4, atol 1e-6; the quantized MLP rtol 2e-2, atol
1e-2 with equal predicted classes); the refusals the JAX texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_parallel_worker as W
from tq_tpu.models import mlp as jmlp
from tq_tpu.parallel.mesh import make_mesh as j_make_mesh
from tq_tpu.parallel.pp import (build_mlp_pipeline as j_build_mlp_pipeline,
                                make_pipeline_mesh as j_pipeline_mesh,
                                make_tr_block_fn as j_tr_block,
                                pipeline_apply as j_pipeline_apply)
from tq_tpu.parallel.serving import BatchRunner as JBatchRunner
from tq_tpu_torch.parallel import launch

F32 = np.float32
DEVICES = 4
PIPELINE_CASES = [(4, 8), (2, 3), (1, 4), (4, 1)]


def _block(p, x):
    return jax.nn.relu(jnp.dot(x, p["w"]) + p["b"])


def _sequential(stage_params, x_micro, block):
    out = []
    for m in range(x_micro.shape[0]):
        h = x_micro[m]
        for s in range(stage_params["w"].shape[0]):
            h = block(jax.tree.map(lambda l: l[s], stage_params), h)
        out.append(h)
    return jnp.stack(out)


def _stages(rng, n_stage, width, bias=0.1):
    return {"w": (rng.normal(size=(n_stage, width, width)) * 0.3).astype(F32),
            "b": (rng.normal(size=(n_stage, width)) * bias).astype(F32)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    pipeline = {}
    for n_stage, n_micro in PIPELINE_CASES:
        pipeline[f"{n_stage}-{n_micro}"] = {
            "n_stage": n_stage, "params": _stages(rng, n_stage, 16),
            "x": rng.normal(size=(n_micro, 8, 16)).astype(F32)}
    pipeline["data2"] = {
        "n_stage": 2, "n_data": 2,
        "params": {**_stages(rng, 2, 8), "b": np.zeros((2, 8), F32)},
        "x": rng.normal(size=(5, 4, 8)).astype(F32)}
    tr = {**_stages(rng, 4, 16), "b": np.zeros((4, 16), F32),
          "w_sf": np.full((4,), 0.01, F32), "a_sf": np.full((4,), 0.05, F32)}
    return {
        "pipeline": pipeline,
        "grads": {"n_stage": 4, "params": _stages(rng, 4, 8),
                  "x": rng.normal(size=(6, 4, 8)).astype(F32)},
        "tr_block": {"n_stage": 4, "params": tr,
                     "x": rng.normal(size=(6, 4, 16)).astype(F32)},
        "mlp_x": rng.normal(size=(4, 8, 20)).astype(F32),
        "serving": {
            "sums": [rng.normal(size=(4, 4)).astype(F32) for _ in range(37)],
            "images": [rng.normal(size=(1, 28, 28)).astype(F32)
                       for _ in range(50)],
            "params": jax.tree.map(np.asarray, jax.device_get(
                jmlp.init(jax.random.PRNGKey(0))))},
    }


@pytest.fixture(scope="module")
def world4(inputs):
    return launch.run(W.pipeline_world4, DEVICES, args=(inputs,),
                      timeout=300)


def _jax_pipeline(case, block):
    mesh = j_pipeline_mesh(case["n_stage"], case.get("n_data"),
                           devices=jax.devices()[:DEVICES])
    sp = jax.tree.map(jnp.asarray, case["params"])
    return mesh, sp, jnp.asarray(case["x"])


@pytest.mark.parametrize("name", [f"{s}-{m}" for s, m in PIPELINE_CASES])
def test_pipeline_matches_sequential(world4, inputs, name):
    case = inputs["pipeline"][name]
    mesh, sp, x = _jax_pipeline(case, _block)
    got = world4["pipeline"][name]
    assert got["mesh"] == tuple(mesh.devices.shape)
    want = np.asarray(j_pipeline_apply(sp, x, _block, mesh))
    np.testing.assert_allclose(got["y"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["y"], np.asarray(_sequential(sp, x,
                                                                _block)),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_composes_with_data_axis(world4, inputs):
    case = inputs["pipeline"]["data2"]
    mesh, sp, x = _jax_pipeline(case, _block)
    got = world4["pipeline"]["data2"]
    assert got["mesh"] == (2, 2)
    np.testing.assert_allclose(got["y"], np.asarray(
        j_pipeline_apply(sp, x, _block, mesh)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["y"], np.asarray(_sequential(sp, x,
                                                                _block)),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_sequential(world4, inputs):
    """The hop's backward sends the gradient to the previous stage: the
    stage gradients equal the JAX package's through its pipeline and the
    sequential stages'."""
    mesh, sp, x = _jax_pipeline(inputs["grads"], _block)
    g_pp = jax.grad(lambda p: jnp.sum(
        j_pipeline_apply(p, x, _block, mesh) ** 2))(sp)
    g_seq = jax.grad(lambda p: jnp.sum(_sequential(p, x, _block) ** 2))(sp)
    got = world4["grads"]
    np.testing.assert_allclose(got["y"], np.asarray(
        _sequential(sp, x, _block)), rtol=1e-5, atol=1e-5)
    for k in sp:
        np.testing.assert_allclose(got["grads"][k], np.asarray(g_pp[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grads"][k], np.asarray(g_seq[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_tr_block_under_pipeline(world4, inputs):
    """Term-revealed serving blocks (B1, then a float32 product) run
    under the pipeline unchanged."""
    block = j_tr_block(bits=7, num_keep_terms=3)
    mesh, sp, x = _jax_pipeline(inputs["tr_block"], block)
    got = world4["tr_block"]["y"]
    np.testing.assert_allclose(got, np.asarray(
        j_pipeline_apply(sp, x, block, mesh)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_sequential(sp, x, block)),
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()


def test_mlp_pipeline_end_to_end(world4, inputs):
    """Stem, pipelined trunk and head: the port's log-probs equal the JAX
    package's ``build_mlp_pipeline`` forward on the port's parameters
    and the same images (a 4-stage mesh), and the same parameters run
    stage after stage; they are normalized."""
    logp = world4["mlp_pipeline"]
    assert logp.shape == (4, 8, 10)
    _, j_forward = j_build_mlp_pipeline(jax.random.PRNGKey(0), n_stage=4,
                                        width=32, in_dim=20, n_classes=10)
    mesh = j_pipeline_mesh(4, devices=jax.devices()[:DEVICES])
    want = j_forward(jax.tree.map(jnp.asarray, world4["mlp_params"]),
                     jnp.asarray(inputs["mlp_x"]), mesh)
    np.testing.assert_allclose(logp, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.exp(logp).sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(logp, world4["mlp_sequential"], rtol=1e-5,
                               atol=1e-5)


def test_pipeline_mesh_refusals(world4):
    devices = jax.devices()[:DEVICES]
    with pytest.warns(UserWarning) as caught:
        j_pipeline_mesh(2, n_data=1, devices=devices)
    assert world4["mesh_refusals"]["warning"] == [
        str(w.message) for w in caught]
    for key, fn in (("not_divisible", lambda: j_pipeline_mesh(
            3, devices=devices)), ("too_big", lambda: j_pipeline_mesh(
                4, n_data=2, devices=devices))):
        with pytest.raises(ValueError) as e:
            fn()
        assert world4["mesh_refusals"][key] == str(e.value)


# --------------------------------------------------------------- serving


def test_batches_and_tail_padding(world4, inputs):
    examples = inputs["serving"]["sums"]
    results = world4["serving_sums"]
    assert len(results) == 37
    for e, r in zip(examples, results):
        np.testing.assert_allclose(r, e.sum(), rtol=1e-4, atol=1e-6)


def test_quantized_mlp_serving(world4, inputs):
    params = jax.tree.map(jnp.asarray, inputs["serving"]["params"])
    qparams, qcfg, qstate = jmlp.convert(
        params, jmlp.static_layer_settings(4, 16, 14), 6, 6, True)
    qstate = {k: {**v, "sf": jnp.float32(0.05)} for k, v in qstate.items()}
    fwd = jmlp.make_quantized_apply(qcfg, track=False)
    ref, _ = fwd(qparams, qstate,
                 jnp.asarray(np.stack(inputs["serving"]["images"])))
    results = world4["serving_mlp"]
    assert results.shape == (50, 10)
    np.testing.assert_allclose(results, np.asarray(ref), rtol=2e-2,
                               atol=1e-2)
    np.testing.assert_array_equal(results.argmax(-1),
                                  np.asarray(ref).argmax(-1))


def test_rejects_bad_batch_size(world4):
    mesh = j_make_mesh(DEVICES, 1, devices=jax.devices()[:DEVICES])
    with pytest.raises(ValueError) as e:
        JBatchRunner(lambda x: x, mesh, batch_size=10)
    assert world4["serving_bad_batch"] == str(e.value)
