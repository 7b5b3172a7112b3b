"""The PyTorch port's ResNets against the JAX package's.

* The symbols: ``get_resnet`` (every depth and stem) and
  ``get_resnet_cifar`` have the JAX package's arguments, aux states and
  shapes; ResNet-50's ``FusionPlan`` has 53 conv -> BatchNorm chains, 33
  of them pointwise (the launch counts ``chip_smoke.py`` asserts on the
  card: 53 ``fused_conv_bn_act`` per forward, 33 ``matmul_stats`` per
  train step); the s2d stem computes the standard stem's function.
* The slice as a whole, with weights carried across as numpy arrays:
  one ``ParallelTrainer`` SGD step (momentum 0.9, wd 1e-4, f32) of a
  narrow bottleneck ResNet built from ``residual_unit`` with the training
  conv -> BatchNorm fusion on, against the JAX trainer with the same
  fusion (Pallas under the interpreter): each parameter's delta within
  2e-4 of its norm (the ReLU kink makes one-step deltas discontinuous
  elementwise, so a per-tensor norm is compared), the moving statistics
  at rtol 1e-4 / atol 1e-6; ``forward()`` of ResNet-50 at full width
  (B=1, 32 x 32) with nonzero moving statistics against JAX's eval
  forward at rtol 1e-4 / atol 1e-6 of the probabilities; a JAX
  checkpoint's ``arg:``/``aux:`` parameters loaded into the port.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jax_par
from mxnet_tpu.models import resnet as jax_resnet

import mxnet_tpu_torch.symbol as S
from mxnet_tpu_torch.model import load_checkpoint
from mxnet_tpu_torch.models import (convert_stem_weight_s2d, get_resnet,
                                    get_resnet_cifar, residual_unit,
                                    space_to_depth_batch)
from mxnet_tpu_torch.ops.fusion import FusionPlan
from mxnet_tpu_torch.parallel import ParallelTrainer, make_graph_fn

SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
DELTA_REL = 2e-4


def _shapes(sym, **inputs):
    return (sym.list_arguments(), sym.list_auxiliary_states(),
            sym.infer_shape(**inputs))


@pytest.mark.parametrize("layers,stem", [(18, "standard"), (50, "standard"),
                                         (50, "s2d"), (50, "s2d_input"),
                                         (101, "standard")])
def test_get_resnet_matches_jax(layers, stem):
    hw = (12, 112, 112) if stem == "s2d_input" else (3, 224, 224)
    inputs = dict(data=(2,) + hw, softmax_label=(2,))
    got = _shapes(get_resnet(10, layers, stem=stem), **inputs)
    want = _shapes(jax_resnet.get_resnet(10, layers, stem=stem), **inputs)
    assert got[:2] == want[:2]
    assert got[2] == tuple(want[2])


def test_get_resnet_cifar_matches_jax():
    inputs = dict(data=(2, 3, 28, 28), softmax_label=(2,))
    got = _shapes(get_resnet_cifar(10, 2), **inputs)
    assert got[:2] == _shapes(jax_resnet.get_resnet_cifar(10, 2),
                              **inputs)[:2]


def test_resnet50_chains_give_the_launch_counts():
    """53 conv chains on eval (one fused_conv_bn_act each); in training the
    33 pointwise ones (every _a, every _c, stage1_unit1_sc) run
    matmul_stats and the three strided shortcuts and every 3x3 stay
    unfused; fc1 feeds SoftmaxOutput, so no fused_linear."""
    sym = get_resnet(1000, 50)
    plan = FusionPlan(sym._topo(), sym._heads)
    chains = list(plan.chains.values())
    assert len(chains) == 53
    assert all(k.startswith("conv_bn") for k, _ in chains)
    point = sorted(n[0].name for _, n in chains
                   if FusionPlan._conv_is_pointwise(n[0].params))
    assert len(point) == 33
    assert sum(p.endswith("_a_conv") for p in point) == 16
    assert sum(p.endswith("_c_conv") for p in point) == 16
    assert "stage1_unit1_sc_conv" in point
    assert "stage2_unit1_sc_conv" not in point


def test_stem_s2d_is_the_standard_stem():
    """SpaceToDepth + the converted 4x4 weight + Crop give the 7x7/2 stem's
    output (the JAX package's exact reparameterization), and the host
    transform equals the op; the conversions equal JAX's."""
    rng = np.random.RandomState(0)
    w = rng.randn(8, 3, 7, 7).astype(np.float32)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_array_equal(convert_stem_weight_s2d(w),
                                  jax_resnet.convert_stem_weight_s2d(w))
    np.testing.assert_array_equal(space_to_depth_batch(x),
                                  jax_resnet.space_to_depth_batch(x))
    data = S.Variable("data")
    std = S.Convolution(data, num_filter=8, kernel=(7, 7), stride=(2, 2),
                        pad=(3, 3), no_bias=True, name="c")
    s2d = S.Crop(S.Convolution(S.SpaceToDepth(data, block_size=2),
                               num_filter=8, kernel=(4, 4), pad=(2, 2),
                               no_bias=True, name="c"),
                 offset=(0, 0), h_w=(16, 16), num_args=1)
    xt = torch.from_numpy(x)
    a = make_graph_fn(std)([xt, torch.from_numpy(w)], [], False, None)[0][0]
    b = make_graph_fn(s2d)([xt, torch.from_numpy(
        convert_stem_weight_s2d(w))], [], False, None)[0][0]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        torch.from_numpy(space_to_depth_batch(x)),
        make_graph_fn(S.SpaceToDepth(data, block_size=2))(
            [xt], [], False, None)[0][0])


# -- the slice as a whole ------------------------------------------------------

def _narrow_resnet(sym):
    """A bottleneck ResNet at 32 filters: a 3x3 stem, a unit with a
    projected shortcut, a strided unit, an identity unit."""
    data = sym.Variable("data")
    body = sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           no_bias=True, name="stem_conv")
    body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, name="stem_bn")
    body = sym.Activation(body, act_type="relu", name="stem_relu")
    units = jax_resnet.residual_unit if sym is mx.symbol else residual_unit
    body = units(body, 32, (1, 1), False, "stage1_unit1")
    body = units(body, 32, (2, 2), False, "stage2_unit1")
    body = units(body, 32, (1, 1), True, "stage2_unit2")
    pool = sym.Pooling(body, pool_type="avg", kernel=(1, 1),
                       global_pool=True, name="global_pool")
    fc = sym.FullyConnected(sym.Flatten(pool), num_hidden=10, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")


def _he_params(sym, shapes, seed):
    """Fan-in scaled weights (activations stay O(1) through the units),
    gamma near 1, beta and the moving statistics nonzero."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_weight"):
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.randn(*s)
        else:
            v = 0.1 * rng.randn(*s)
        args[n] = v.astype(np.float32)
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        v = 0.1 * rng.randn(*s) if n.endswith("mean") \
            else rng.uniform(0.5, 1.5, s)
        aux[n] = v.astype(np.float32)
    return args, aux


def _batch(shapes, seed, classes):
    rs = np.random.RandomState(seed)
    return {"data": rs.rand(*shapes["data"]).astype(np.float32),
            "softmax_label": rs.randint(0, classes, shapes["softmax_label"]
                                        ).astype(np.float32)}


NARROW = {"data": (4, 3, 16, 16), "softmax_label": (4,)}


@pytest.fixture(scope="module")
def narrow_jax_step():
    """Parameters and aux of the JAX trainer after one SGD step, with the
    training conv -> BatchNorm fusion on (matmul_stats, interpreted)."""
    jsym = _narrow_resnet(mx.symbol)
    args, aux = _he_params(jsym, NARROW, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_PALLAS_FUSION", "1")
        mp.setenv("MXNET_PALLAS_CONVBN_TRAIN", "1")
        mp.setenv("MXNET_BN_STATS", "auto")
        tr = jax_par.ParallelTrainer(
            jsym, NARROW, optimizer="sgd", optimizer_params=dict(SGD),
            mesh=jax_par.data_parallel_mesh(1))
        tr.init_params({k: mx.nd.array(v) for k, v in args.items()},
                       {k: mx.nd.array(v) for k, v in aux.items()})
        tr.step(_batch(NARROW, 1, 10))
        got, got_aux = tr.get_params()
    return ({k: v.asnumpy() for k, v in got.items()},
            {k: v.asnumpy() for k, v in got_aux.items()}, args, aux)


@pytest.mark.parametrize("convbn", ["1", None])
def test_trainer_step_matches_jax(narrow_jax_step, convbn, monkeypatch):
    """The port with the training fusion on (matmul_stats' plain version)
    and off (the unfused ops) against the JAX step with it on."""
    want, want_aux, args, aux = narrow_jax_step
    if convbn:
        monkeypatch.setenv("MXNET_PALLAS_CONVBN_TRAIN", convbn)
    else:
        monkeypatch.delenv("MXNET_PALLAS_CONVBN_TRAIN", raising=False)
    tr = ParallelTrainer(_narrow_resnet(S), NARROW, optimizer="sgd",
                         optimizer_params=dict(SGD), device="cpu")
    tr.init_params(args, aux)
    tr.step(_batch(NARROW, 1, 10))
    got, got_aux = tr.get_params()
    assert set(got) == set(want)
    for n in want:
        delta_j = want[n] - args[n]
        delta_t = got[n].numpy() - args[n]
        err = np.linalg.norm(delta_t - delta_j) / np.linalg.norm(delta_j)
        assert err <= DELTA_REL, (n, err)
    for n in want_aux:
        assert got_aux[n].dtype == torch.float32
        np.testing.assert_allclose(got_aux[n].numpy(), want_aux[n],
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_trainer_bf16_keeps_f32_moving_stats_and_learns():
    """bf16 compute with the fusion on: the moving statistics stay f32
    across steps, the labels are not cast, the loss falls."""
    shapes = {"data": (8, 3, 16, 16), "softmax_label": (8,)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_PALLAS_CONVBN_TRAIN", "1")
        tr = ParallelTrainer(_narrow_resnet(S), shapes,
                             optimizer_params={"learning_rate": 0.05,
                                               "momentum": 0.9},
                             compute_dtype="bfloat16", device="cpu", seed=2)
        args, aux = _he_params(tr.symbol, shapes, 3)
        tr.init_params(args, aux)
        batch = _batch(shapes, 4, 10)
        lab = torch.as_tensor(batch["softmax_label"]).long()
        losses = []
        for _ in range(5):
            p = tr.step(batch)[0]
            assert p.dtype == torch.bfloat16
            losses.append(-torch.log(p.float().gather(1, lab[:, None])
                                     ).mean().item())
    assert tr._no_cast == {"softmax_label"}
    assert all(a.dtype == torch.float32 for a in tr.aux)
    assert not torch.equal(tr.aux[0], torch.from_numpy(aux["stem_bn_"
                                                           "moving_mean"]))
    assert losses[-1] < losses[0] - 0.05, losses


RESNET50 = {"data": (1, 3, 32, 32), "softmax_label": (1,)}


def _jax_forward(jsym, shapes, args, aux, batch):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_PALLAS_FUSION", "1")
        tr = jax_par.ParallelTrainer(jsym, shapes,
                                     mesh=jax_par.data_parallel_mesh(1))
        tr.init_params({k: mx.nd.array(v) for k, v in args.items()},
                       {k: mx.nd.array(v) for k, v in aux.items()})
        return np.asarray(tr.forward(batch)[0])


@pytest.fixture(scope="module")
def resnet50_jax():
    """ResNet-50 at full width, fan-in scaled weights, nonzero moving
    statistics; JAX's eval forward (fused_conv_bn_act interpreted)."""
    jsym = jax_resnet.get_resnet(1000, 50)
    args, aux = _he_params(jsym, RESNET50, 5)
    batch = _batch(RESNET50, 6, 1000)
    return args, aux, batch, _jax_forward(jsym, RESNET50, args, aux, batch)


def test_resnet50_forward_matches_jax(resnet50_jax):
    args, aux, batch, want = resnet50_jax
    tr = ParallelTrainer(get_resnet(1000, 50), RESNET50, device="cpu")
    tr.init_params(args, aux)
    got = tr.forward(batch)[0].numpy()
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert got.argmax() == want.argmax()


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """save_checkpoint in the JAX package, load_checkpoint in the port:
    the arg: and aux: parameters (the moving statistics among them) give
    the same eval forward."""
    shapes = {"data": (2, 3, 28, 28), "softmax_label": (2,)}
    jsym = jax_resnet.get_resnet_cifar(10, 1)
    args, aux = _he_params(jsym, shapes, 7)
    prefix = os.path.join(str(tmp_path), "cifar")
    mx.model.save_checkpoint(prefix, 3, jsym,
                             {k: mx.nd.array(v) for k, v in args.items()},
                             {k: mx.nd.array(v) for k, v in aux.items()})
    batch = _batch(shapes, 8, 10)
    want = _jax_forward(jsym, shapes, args, aux, batch)
    sym, arg_params, aux_params = load_checkpoint(prefix, 3)
    assert set(aux_params) == set(aux) and set(arg_params) == set(args)
    for n, v in aux.items():
        np.testing.assert_array_equal(aux_params[n].asnumpy(), v)
    tr = ParallelTrainer(sym, shapes, device="cpu")
    tr.init_params(arg_params, aux_params)
    np.testing.assert_allclose(tr.forward(batch)[0].numpy(), want,
                               rtol=1e-4, atol=1e-6)
