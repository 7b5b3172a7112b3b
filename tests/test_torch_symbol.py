"""Symbols, ``.params`` files and checkpoints cross between the packages.

A graph built by either package serialises to the same JSON and loads
in the other with the same arguments and shapes; a ``.params`` file
written by either loads bit-exact in the other; ``params_from_numpy``
checks every shape against the symbol before placing a tensor.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.name import NameManager as JaxNames

from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import Context, cpu, gpu, resolve_device
from mxnet_tpu_torch.models import get_transformer_lm as torch_lm
from mxnet_tpu_torch.name import NameManager as TorchNames

LM_CONFIGS = {
    "learned": dict(num_layers=2, embed_dim=32, num_heads=4),
    "gqa_rope": dict(num_layers=1, embed_dim=32, num_heads=4,
                     num_kv_heads=2, pos_encoding="rope"),
    "flat": dict(num_layers=1, embed_dim=16, num_heads=2,
                 loss_layout="flat"),
}


def _pair(cfg):
    with JaxNames():
        j = jax_lm(29, **LM_CONFIGS[cfg])
    with TorchNames():
        t = torch_lm(29, **LM_CONFIGS[cfg])
    return j, t


@pytest.mark.parametrize("cfg", sorted(LM_CONFIGS))
def test_lm_json_is_the_same_graph(cfg):
    j, t = _pair(cfg)
    assert json.loads(t.tojson()) == json.loads(j.tojson())


@pytest.mark.parametrize("cfg", sorted(LM_CONFIGS))
def test_json_loads_across_packages(cfg):
    j, t = _pair(cfg)
    t_from_j = tsym.load_json(j.tojson())
    j_from_t = mx.sym.load_json(t.tojson())
    for a, b in ((t_from_j, j), (j_from_t, t)):
        assert a.list_arguments() == b.list_arguments()
        assert a.list_outputs() == b.list_outputs()
        assert a.list_auxiliary_states() == b.list_auxiliary_states()
    assert json.loads(t_from_j.tojson()) == json.loads(j.tojson())


@pytest.mark.parametrize("cfg", sorted(LM_CONFIGS))
def test_infer_shape_agrees(cfg):
    j, t = _pair(cfg)
    shapes = dict(data=(3, 12), softmax_label=(3, 12))
    ja, jo, jx = j.infer_shape(**shapes)
    ta, to, tx = t.infer_shape(**shapes)
    assert [tuple(s) for s in ta] == [tuple(s) for s in ja]
    assert [tuple(s) for s in to] == [tuple(s) for s in jo]
    assert list(tx) == list(jx)
    assert t.infer_shape(softmax_label=(3, 12))[0] is None


def test_get_internals_and_getitem():
    _, t = _pair("learned")
    internals = t.get_internals()
    head = internals["lm_head_output"]
    assert head.list_outputs() == ["lm_head_output"]
    assert "lm_head_weight" in head.list_arguments()
    with pytest.raises(MXNetError):
        internals["no_such_output"]


def test_symbol_save_load_file(tmp_path):
    _, t = _pair("gqa_rope")
    path = str(tmp_path / "lm-symbol.json")
    t.save(path)
    back = tsym.load(path)
    assert back.tojson() == t.tojson()
    assert mx.sym.load(path).list_arguments() == t.list_arguments()


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "f64": rng.randn(4).astype(np.float64),
        "f16": rng.randn(2, 2, 2).astype(np.float16),
        "u8": rng.randint(0, 256, (7,)).astype(np.uint8),
        "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32),
        "bf16": rng.randn(6).astype(np.float32).astype(ml_dtypes.bfloat16),
        "empty": np.zeros((0, 4), np.float32),
    }


def test_params_jax_to_torch_bit_exact(tmp_path):
    arrays = _arrays(0)
    path = str(tmp_path / "j.params")
    mx.nd.save(path, {k: mx.nd.array(v, dtype=v.dtype)
                      for k, v in arrays.items()})
    got = tnd.load(path)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        g = got[k]
        if k == "bf16":
            g = g.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            g = g.numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert g.tobytes() == v.tobytes(), k
    with open(path, "rb") as f:
        buf = tnd.load_buffer(f.read())
    assert torch.equal(buf["f32"], got["f32"])


def test_params_torch_to_jax_bit_exact(tmp_path):
    arrays = _arrays(1)
    data = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
            if k == "bf16" else torch.from_numpy(v)
            for k, v in arrays.items()}
    path = str(tmp_path / "t.params")
    tnd.save(path, data)
    got = mx.nd.load(path)
    for k, v in arrays.items():
        g = got[k].asnumpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert g.tobytes() == v.tobytes(), k
    # byte-identical files from the same arrays
    path_j = str(tmp_path / "j.params")
    mx.nd.save(path_j, {k: mx.nd.array(v, dtype=v.dtype)
                        for k, v in arrays.items()})
    with open(path, "rb") as a, open(path_j, "rb") as b:
        assert a.read() == b.read()


def test_params_list_and_errors(tmp_path):
    path = str(tmp_path / "l.params")
    tnd.save(path, [np.arange(3, dtype=np.float32), torch.ones(2, 2)])
    got = tnd.load(path)
    assert isinstance(got, list) and len(got) == 2
    assert mx.nd.load(path)[1].shape == (2, 2)
    with pytest.raises(MXNetError):
        tnd.save(path, {"x": [1, 2, 3]})
    with pytest.raises(MXNetError):
        tnd.save(path, {"x": torch.ones(2, dtype=torch.int8)})
    with pytest.raises(MXNetError):
        tnd.load_buffer(b"\x00" * 24)


def _lm_params(sym, seed=0):
    shapes, _, _ = sym.infer_shape(data=(1, 16), softmax_label=(1, 16))
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def test_checkpoint_crosses_both_ways(tmp_path):
    j, t = _pair("learned")
    params = _lm_params(t)
    pj = str(tmp_path / "jax")
    mx.model.save_checkpoint(pj, 3, j, {k: mx.nd.array(v)
                                        for k, v in params.items()}, {})
    sym, args, aux = tmodel.load_checkpoint(pj, 3)
    assert sym.tojson() == t.tojson() and aux == {}
    for k, v in params.items():
        assert args[k].numpy().tobytes() == v.tobytes()
    pt = str(tmp_path / "torch")
    tmodel.save_checkpoint(pt, 0, t, {k: torch.from_numpy(v)
                                      for k, v in params.items()}, {})
    assert os.path.exists(pt + "-symbol.json")
    assert os.path.exists(pt + "-0000.params")
    jsym, jargs, _ = mx.model.load_checkpoint(pt, 0)
    assert jsym.list_arguments() == t.list_arguments()
    for k, v in params.items():
        assert jargs[k].asnumpy().tobytes() == v.tobytes()


def test_params_from_numpy_checks_shapes():
    _, t = _pair("learned")
    params = _lm_params(t)
    out = tmodel.params_from_numpy(params, "cpu", symbol=t,
                                   input_shapes={"data": (1, 16)})
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in out.values())
    assert torch.equal(out["lm_head_weight"],
                       torch.from_numpy(params["lm_head_weight"]))
    bf = tmodel.params_from_numpy(params, "cpu", dtype="bfloat16")
    assert bf["embed_weight"].dtype == torch.bfloat16
    bad = dict(params)
    bad["layer0_ffn1_weight"] = bad["layer0_ffn1_weight"].T.copy()
    with pytest.raises(MXNetError, match="layer0_ffn1_weight"):
        tmodel.params_from_numpy(bad, "cpu", symbol=t,
                                 input_shapes={"data": (1, 16)})
    with pytest.raises(MXNetError, match="input_shapes"):
        tmodel.params_from_numpy(params, "cpu", symbol=t)


def test_context_maps_to_torch_devices():
    assert gpu(1).torch_device == torch.device("cuda", 1)
    assert cpu().torch_device == torch.device("cpu")
    assert Context("gpu", 2) == gpu(2) and str(gpu(0)) == "gpu(0)"
    with cpu(0) as c:
        assert Context.default_ctx is c
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(cpu()) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            resolve_device(None)
        with pytest.raises(MXNetError):
            resolve_device(gpu(0))


def test_unported_parts_raise():
    with pytest.raises(MXNetError):
        torch_lm(29, num_layers=1, embed_dim=16, num_heads=2, num_experts=2)
    t = torch_lm(29, num_layers=1, embed_dim=16, num_heads=2)
    node = [n for n in t._topo() if not n.is_var
            and n.spec.name == "MultiHeadAttention"][0]
    ins = [torch.zeros(1, 4, 16), torch.zeros(48, 16), torch.zeros(48),
           torch.zeros(16, 16), torch.zeros(16)]
    # the ring impls are ported but run only in the SPMD walk of
    # SequenceParallelTrainer, which hands them every rank's inputs
    with pytest.raises(MXNetError, match="SequenceParallelTrainer"):
        node.spec.forward(dict(node.params, impl="ring"), ins, [], False,
                          None)
