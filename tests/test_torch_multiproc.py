"""The port's ``ParallelTrainer`` and ``PipelineTrainer`` over meshes that
span worker processes: two workers launched by the unchanged
``tools/launch.py -n 2 --local-devices 2`` (4 ranks on the host, 2 a
process, so the sums run over 4 ranks in rank order) join one gloo group
and run the checks ``trainer``, ``shardio``, ``lm_dp``, ``bn_global``,
``ckpt`` and ``pipe`` of ``mxnet_tpu_torch.testing.dist_worker`` at their
tiny size, each process passing its rows of the global batch.

Oracles: the port's own one-process run over ``["cpu"] * 4`` from the
same weights and global batches, bitwise (parameters, optimizer states,
BatchNorm moving averages), and both ranks bitwise equal; the JAX
package's one-process ``ParallelTrainer`` over 4 CPU devices, as
``tests/test_dist.py`` builds its oracle: the FC check's parameter
checksum within 1e-4, the LM's and the BatchNorm net's parameter deltas
within 2e-2 by norm per tensor (f32; another order of sums), the moving
statistics within rtol 1e-4; the JAX package's ``load_sharded`` reading
the 2-process checkpoint; the sharded-IO fit above 0.85, equal in both
processes. The pipelines (``pipe``: {pp: 2} a stage a process, {dp: 2,
pp: 2} with pp or dp across the processes, a pp-sharded parameter
across them, ``param_placement="replicated"``; GPipe and 1F1B): both
ranks' ``get_params()`` and each rank's optimizer state bitwise the
port's one-process run over the same mesh shape on ``["cpu"] * n``, the
head output only in the processes that run a last stage, equal to the
one-process rows; the parameters within ``test_torch_pipeline.py``'s
tolerance (rtol 2e-4, atol 2e-5) of the JAX package's
``PipelineTrainer`` on as many CPU devices, and their deltas within 2e-2
by norm (the ReLU kink). The sequence-parallel LM (``sp``: {dp, sp}
meshes a rank a process, 2 ranks a process, dp across with the rings
inside a process, sp across with dp inside; ``ring_striped`` and
``ring``): both ranks' parameters and optimizer state bitwise the port's
one-process ``SequenceParallelTrainer`` over the same mesh shape, the
same losses in both, no ring crossing where dp alone crosses; within
``test_torch_sp.py``'s tolerance of the JAX package's trainer on as many
CPU devices; its 2-process checkpoint restored in one process and a
one-process checkpoint (written here before the launch) in two, bitwise.
AdaFactor with ``fsdp`` (its factored state sharded across the
processes) bitwise the one-process run and within 2e-2 by norm of the
JAX package's deltas.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import get_transformer_lm as jax_lm
from mxnet_tpu.parallel import checkpoint as jckpt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.parallel.checkpoint import load_sharded
from mxnet_tpu_torch.testing import dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = ("trainer", "shardio", "lm_dp", "bn_global", "ckpt", "pipe",
          "sp")
CPU4 = ["cpu"] * 4
DELTA_REL = 2e-2
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("multiproc")
    env = dict(os.environ)
    env.update(MXNET_DISTTEST_CHECKS=",".join(CHECKS),
               MXNET_DISTTEST_OUT=str(out), MXNET_DISTTEST_CTX="cpu",
               MXNET_DISTTEST_SIZE="tiny",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    for k in ("MXNET_KVSTORE_PORT_BASE", "MXNET_TPU_COORDINATOR"):
        env.pop(k, None)
    # the one-process SP checkpoint the workers restore in two processes
    tr, _ = _sp_port("ring_striped", "b")
    tr.save_sharded_checkpoint(os.path.join(out, "sp-onep"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         "2", "--local-devices", "2", "--", sys.executable, "-m",
         "mxnet_tpu_torch.testing.dist_worker"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-4000:]
    return out, text


def _npz(out, name):
    return [dict(np.load(os.path.join(out, "%s-%d.npz" % (name, r))))
            for r in range(2)]


def _json(out, name):
    out_ = []
    for r in range(2):
        with open(os.path.join(out, "%s-%d.json" % (name, r))) as f:
            out_.append(json.load(f))
    return out_


def _equal(got, want, what):
    assert sorted(got) == sorted(want), what
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, (what, bad)


def _ranks_and_oracle(out, name, tr):
    """Both ranks' state bitwise equal to the one-process trainer's."""
    want = W.trainer_state(tr)
    ranks = _npz(out, name)
    for r, got in enumerate(ranks):
        _equal(got, want, "%s rank %d" % (name, r))
    return want


def _delta_gate(what, got, init, want):
    """Per-tensor parameter deltas within DELTA_REL of the JAX
    package's by norm, plus 1e-6 of the tensor's norm (the bias of a
    convolution before a BatchNorm has a gradient of rounding noise,
    ~1e-9 in one package and 0 in the other)."""
    for n, w in want.items():
        dw = w - init[n]
        dg = got[n] - init[n]
        err = np.linalg.norm(dg - dw)
        assert err <= DELTA_REL * np.linalg.norm(dw) \
            + 1e-6 * np.linalg.norm(init[n]), (what, n, err)


@pytest.mark.parametrize("check", CHECKS + ("all",))
def test_every_rank_passes(launched, check):
    _, text = launched
    assert text.count("OK %s rank=" % check) == 2, text[-3000:]


def test_trainer_matches_one_process_and_jax(launched):
    """The JAX package's check_trainer: cross-process dp (3 steps, and
    multi_step, asserted equal in the workers) equals the one-process
    run, bitwise in the port and within 1e-4 of the JAX trainer's
    checksum; the eval forward of each process's rows returns the
    global batch's outputs, the one-process forward's."""
    out, _ = launched
    init, batch = W.fc_problem()
    shapes = {k: v.shape for k, v in batch.items()}
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    tr = par.ParallelTrainer(W.fc_symbol(mx), shapes, optimizer="sgd",
                             mesh=par.build_mesh({"dp": 4}, CPU4),
                             optimizer_params=opt)
    tr.init_params(init)
    for _ in range(3):
        tr.step(batch)
    fwd = tr.forward(batch)[0].numpy()
    for got in _npz(out, "trainer"):
        assert np.array_equal(got.pop("forward"), fwd)
    want = W.trainer_state(tr)
    for r, got in enumerate(_npz(out, "trainer")):
        got.pop("forward")
        _equal(got, want, "trainer rank %d" % r)
    jtr = jpar.ParallelTrainer(W.fc_symbol(jmx), shapes, optimizer="sgd",
                               mesh=jpar.build_mesh({"dp": 4}),
                               optimizer_params=opt)
    jtr.init_params({k: jmx.nd.array(v) for k, v in init.items()})
    for _ in range(3):
        jtr.step(batch)
    jw = jtr.get_params()[0]["fc_weight"].asnumpy()
    assert abs(np.abs(want["arg:fc_weight"]).sum()
               - np.abs(jw).sum()) < 1e-4


def _lm_port(variant_kw):
    cfg = W.LM_SIZES["tiny"]
    tr = W.lm_trainer(par, cfg, par.build_mesh({"dp": 4}, CPU4),
                      **variant_kw)
    init = {k: v.numpy() for k, v in tr.get_params()[0].items()}
    batch = W.lm_batch(cfg)
    for _ in range(W.LM_DP_STEPS["tiny"]):
        tr.step(batch)
    return tr, init, batch


@pytest.fixture(scope="module")
def lm_jax():
    """The JAX package's dp=4 LM trainer, 3 steps from the port's initial
    weights (seed 0 of the port's default initializer)."""
    cfg = W.LM_SIZES["tiny"]
    _, init, batch = _lm_port({})
    shapes = {k: v.shape for k, v in batch.items()}
    jsym = jax_lm(cfg["vocab"], num_layers=cfg["layers"],
                  embed_dim=cfg["embed"], num_heads=cfg["heads"],
                  impl="flash")
    jtr = jpar.ParallelTrainer(
        jsym, shapes, optimizer="sgd", mesh=jpar.build_mesh({"dp": 4}),
        optimizer_params={"learning_rate": W.LM_LR, "momentum": 0.9})
    jtr.init_params({k: jmx.nd.array(v) for k, v in init.items()})
    for _ in range(W.LM_DP_STEPS["tiny"]):
        jtr.step(batch)
    return init, {k: v.asnumpy() for k, v in jtr.get_params()[0].items()}


@pytest.mark.parametrize("variant", [v for v, _ in W.LM_VARIANTS])
def test_lm_dp_matches_one_process_and_jax(launched, lm_jax, variant):
    """The LM across 2 processes x 2 ranks: plain, zero1 and fsdp each
    bitwise the one-process 4-rank run and each other; the loss falls;
    the step is two programs with host stages between them; within
    2e-2 by norm of the JAX package's deltas."""
    out, _ = launched
    kw = dict(W.LM_VARIANTS)[variant]
    tr, init, _ = _lm_port(kw)
    want = _ranks_and_oracle(out, "lm_dp-" + variant, tr)
    plain = _npz(out, "lm_dp-plain")[0]
    for k, v in want.items():
        assert np.array_equal(plain[k], v), k
    res = _json(out, "lm_dp-" + variant)
    for r in res:
        assert r["loss"][-1] < r["loss"][0]
        assert r["compile_counts"] == {"step.compute": 1, "step.update": 1}
        assert r["programs"] == 2 and r["captured"] == 0
        # the reduce and the output stage; fsdp gathers the parameters
        # first, zero1 the chunks after the update
        assert r["host_stages"] == (3 if variant != "plain" else 2)
        assert r["cross_bytes"] > 0
    assert res[0]["loss"] == res[1]["loss"]
    jinit, jwant = lm_jax
    _delta_gate(variant, {k[4:]: v for k, v in want.items()
                          if k.startswith("arg:")}, jinit, jwant)


@pytest.mark.parametrize("accum", W.BN_SIZES["tiny"]["accum"])
def test_bn_global_matches_one_process_and_jax(launched, accum):
    """A training BatchNorm over the global batch of both processes (and
    grad_accum's global-row microbatches), under a global-norm clip that
    binds (the gradient's norm is ~4): parameters, moving averages and
    optimizer states bitwise the one-process 4-rank run's; the JAX
    package's within 2e-2 by norm (deltas) and rtol 1e-4 (moving
    statistics)."""
    out, _ = launched
    cfg = W.BN_SIZES["tiny"]
    sym = W.bn_symbol(mx, cfg)
    args, aux, batches = W.bn_problem(sym, cfg)
    shapes = {k: v.shape for k, v in batches[0].items()}
    opt = dict(optimizer="sgd", grad_accum=accum,
               clip_grad_norm=cfg["clip"],
               optimizer_params={"learning_rate": W.BN_LR,
                                 "momentum": 0.9})
    tr = par.ParallelTrainer(sym, shapes, mesh=par.build_mesh(
        {"dp": 4}, CPU4), **opt)
    tr.init_params(args, aux)
    for b in batches:
        tr.step(b)
    want = _ranks_and_oracle(out, "bn_global-%d" % accum, tr)
    jtr = jpar.ParallelTrainer(W.bn_symbol(jmx, cfg), shapes,
                               mesh=jpar.build_mesh({"dp": 4}), **opt)
    jtr.init_params({k: jmx.nd.array(v) for k, v in args.items()},
                    {k: jmx.nd.array(v) for k, v in aux.items()})
    for b in batches:
        jtr.step(b)
    jargs, jaux = jtr.get_params()
    _delta_gate("bn accum %d" % accum,
                {k[4:]: v for k, v in want.items() if k.startswith("arg:")},
                args, {k: v.asnumpy() for k, v in jargs.items()})
    for k, v in jaux.items():
        np.testing.assert_allclose(want["aux:" + k], v.asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # the walk holds the BatchNorm's cross-process sums: uncaptured
    for r in _json(out, "bn_global-%d" % accum):
        assert r["programs"] == 2 and r["cross_calls"] > 2


def test_ckpt_two_processes_restore_in_one_and_in_jax(launched):
    """save_sharded_checkpoint of lm_dp's fsdp trainer from 2
    processes, sync and async: one file per process and a manifest with
    nprocs 2; restored in one process (an fsdp trainer on 4 ranks and a
    one-device trainer) bitwise the saved state (lm_dp's, itself bitwise
    the one-process run's); the JAX package's load_sharded reads it (the
    restore in 2 processes is asserted in the workers)."""
    out, _ = launched
    want = _npz(out, "ckpt")
    _equal(want[1], want[0], "ckpt ranks")
    want = want[0]
    _equal(want, _npz(out, "lm_dp-fsdp")[0], "ckpt is lm_dp's fsdp state")
    cfg = W.LM_SIZES["tiny"]
    jmesh = jpar.build_mesh({"dp": 4})
    for how in ("sync", "async"):
        prefix = os.path.join(out, "ckpt-" + how)
        with open(prefix + "-manifest.json") as f:
            manifest = json.load(f)
        # lm_dp's fsdp trainer after its steps
        assert manifest["nprocs"] == 2 \
            and manifest["step"] == W.LM_DP_STEPS["tiny"]
        assert ("save_token" in manifest) == (how == "async")
        for r in range(2):
            assert os.path.exists("%s-shards-p%d.npz" % (prefix, r))
        for kw in (dict(mesh=par.build_mesh({"dp": 4}, CPU4), fsdp=True),
                   dict(mesh=None)):
            shape = (cfg["b"], cfg["t"])
            tr = par.ParallelTrainer(
                W.lm_symbol(cfg), {"data": shape, "softmax_label": shape},
                optimizer="sgd",
                optimizer_params={"learning_rate": W.LM_LR,
                                  "momentum": 0.9},
                device=None if kw.get("mesh") else "cpu", **kw)
            tr.restore_sharded_checkpoint(prefix)
            _equal(W.trainer_state(tr), want, "%s restore %s" % (how, kw))
        flat, step, _ = jckpt.load_sharded(prefix, jmesh)
        assert step == W.LM_DP_STEPS["tiny"]
        for k, v in want.items():
            kind, name = k.split(":", 1)
            key = name if kind == "arg" else (
                "aux/" + name if kind == "aux"
                else "opt/%s/%s" % tuple(name.rsplit(":", 1)))
            assert np.array_equal(np.asarray(flat[key]), v), (how, k)


def test_shardio_converges_with_equal_metrics(launched):
    out, _ = launched
    res = _json(out, "shardio")
    assert res[0]["acc"] > 0.85 and res[0]["acc"] == res[1]["acc"]


PIPE_RUNS = [(layout, schedule) for layout in W.PIPE_LAYOUTS["tiny"]
             for schedule in W.pipe_schedules(layout)]
_PIPE_JAX = {}


def _pipe_jax(axes, schedule, init, batch):
    """The JAX package's PipelineTrainer on the mesh ``axes`` of CPU
    devices, LM_STEPS steps from ``init`` (the port's initial weights):
    its parameters, once for each mesh shape and schedule."""
    key = (tuple(axes.items()), schedule)
    if key not in _PIPE_JAX:
        cfg = W.LM_SIZES["tiny"]
        jsym = jax_lm(cfg["vocab"], num_layers=cfg["layers"],
                      embed_dim=cfg["embed"], num_heads=cfg["heads"],
                      impl="flash", pipeline_stages=2)
        jtr = jpar.PipelineTrainer(
            jsym, {k: v.shape for k, v in batch.items()},
            jpar.build_mesh(axes), num_microbatches=W.PIPE_M,
            optimizer="sgd", schedule=schedule,
            optimizer_params={"learning_rate": W.LM_LR, "momentum": 0.9})
        jtr.init_params({k: jmx.nd.array(v) for k, v in init.items()})
        for _ in range(W.LM_STEPS):
            jtr.step(batch)
        _PIPE_JAX[key] = {k: v.asnumpy()
                          for k, v in jtr.get_params().items()}
    return _PIPE_JAX[key]


@pytest.mark.parametrize("layout,schedule", PIPE_RUNS)
def test_pipe_matches_one_process_and_jax(launched, layout, schedule):
    """PipelineTrainer across 2 processes (the layout's ranks placed by
    ``dist_worker.pipe_mesh``): both ranks' whole parameters and each
    rank's optimizer state bitwise the one-process run over the same
    mesh shape, the loss falling; the head only where a process runs a
    last stage, its rows the one-process head's; a pp hop across the
    processes runs the step uncaptured, dp across them a chain; seed=None
    is process 0's in both; within the JAX package's pipeline."""
    out, _ = launched
    cfg = W.LM_SIZES["tiny"]
    axes = W.PIPE_AXES[layout]
    n = int(np.prod(list(axes.values())))
    tr = W.pipe_trainer(par, cfg, par.build_mesh(axes, ["cpu"] * n),
                        schedule, **W.PIPE_KW[layout])
    init = {k: v.numpy() for k, v in tr.get_params().items()}
    batch = W.lm_batch(cfg)
    for _ in range(W.LM_STEPS):
        head = tr.step(batch)
    want = W.pipe_state(tr)
    name = "pipe-%s-%s" % (layout, schedule)
    ranks, res = _npz(out, name), _json(out, name)
    for r, (got, info) in enumerate(zip(ranks, res)):
        lo, hi = info["process_rows"]
        if layout == "c":
            assert (lo, hi) == (r * cfg["b"] // 2, (r + 1) * cfg["b"] // 2)
        assert info["has_head"] == (layout == "c" or r == 1)
        path = os.path.join(out, "%s-head-%d.npy" % (name, r))
        assert os.path.exists(path) == info["has_head"]
        if info["has_head"]:
            assert np.array_equal(np.load(path), head.numpy()[lo:hi])
        assert all(k in got for k in want if k.startswith("arg:"))
        _equal(got, {k: want[k] for k in got}, "%s rank %d" % (name, r))
        assert info["loss"][-1] < info["loss"][0]
        assert info["seed_none"] == res[0]["seed_none"]
        assert info["cross_bytes"] > 0
        if layout == "c":
            assert info["compile_counts"] == {"step.compute": 1,
                                              "step.update": 1}
            assert info["programs"] == 2 and info["host_stages"] == 2
        else:
            assert info["compile_counts"] == {"step": 1}
            assert info["programs"] == 1 and info["host_stages"] == 0
    assert set(ranks[0]) | set(ranks[1]) == set(want)
    assert res[0]["loss"] == res[1]["loss"]
    got = {k[4:]: v for k, v in want.items() if k.startswith("arg:")}
    jwant = _pipe_jax(axes, schedule, init, batch)
    for k in jwant:
        np.testing.assert_allclose(got[k], jwant[k], err_msg=k, **TOL)
    _delta_gate(name, got, init, jwant)


SP_RUNS = [(impl, layout) for impl in W.SP_SIZES["tiny"]["impls"]
           for layout in W.SP_LAYOUTS["tiny"]]
_SP_JAX = {}


def _sp_port(impl, layout, steps=W.LM_STEPS):
    """The port's one-process SequenceParallelTrainer over layout
    ``layout``'s mesh shape on ``["cpu"] * n``, ``steps`` steps on the
    check's batch, and its initial parameters."""
    cfg = W.SP_SIZES["tiny"]
    axes = W.SP_AXES[layout]
    tr = W.sp_trainer(par, cfg, par.build_mesh(axes, ["cpu"] * (
        axes["dp"] * axes["sp"])), impl)
    init = {k: v.numpy() for k, v in tr.get_params().items()}
    batch = W.lm_batch(cfg)
    tr.losses = [float(tr.step(batch)) for _ in range(steps)]
    return tr, init


def _sp_jax(impl, axes, init):
    """The JAX package's SequenceParallelTrainer on the mesh ``axes`` of
    CPU devices, LM_STEPS steps from ``init``: its parameters, once for
    each impl and mesh shape."""
    key = (impl, tuple(axes.items()))
    if key not in _SP_JAX:
        cfg = W.SP_SIZES["tiny"]
        batch = W.lm_batch(cfg)
        jtr = jpar.SequenceParallelTrainer(
            jax_lm(cfg["vocab"], num_layers=cfg["layers"],
                   embed_dim=cfg["embed"], num_heads=cfg["heads"],
                   impl=impl), {k: v.shape for k, v in batch.items()},
            jpar.build_mesh(axes), optimizer="sgd",
            optimizer_params={"learning_rate": W.LM_LR, "momentum": 0.9})
        jtr.init_params({k: jmx.nd.array(v) for k, v in init.items()})
        for _ in range(W.LM_STEPS):
            jtr.step(batch)
        _SP_JAX[key] = {k: v.asnumpy() for k, v in jtr.get_params().items()}
    return _SP_JAX[key]


@pytest.mark.parametrize("impl,layout", SP_RUNS)
def test_sp_matches_one_process_and_jax(launched, impl, layout):
    """SequenceParallelTrainer across 2 processes (the layout's ranks
    placed by ``dist_worker.sp_mesh``, every process passing the global
    batch): both ranks' parameters and optimizer state bitwise the
    one-process run over the same mesh shape; the losses the one-process
    run's in both, falling; the ring's hops and deals cross the
    processes except where dp alone does (the gradient's and the loss's
    sums alone: 2 calls a step); within the JAX package's trainer."""
    out, _ = launched
    tr, init = _sp_port(impl, layout)
    want = W.sp_state(tr)
    name = "sp-%s-%s" % (impl, layout)
    for r, (got, info) in enumerate(zip(_npz(out, name), _json(out, name))):
        _equal(got, want, "%s rank %d" % (name, r))
        assert info["loss"] == tr.losses, (info["loss"], tr.losses)
        assert info["loss"][-1] < info["loss"][0]
        assert info["cross_bytes"] > 0
        if layout == "c":
            assert info["cross_calls"] == 2
        else:
            assert info["cross_calls"] > 2
    jwant = _sp_jax(impl, W.SP_AXES[layout], init)
    got = {k[4:]: v for k, v in want.items() if k.startswith("arg:")}
    assert set(got) == set(jwant)
    for k in jwant:
        np.testing.assert_allclose(got[k], jwant[k], err_msg=k, **TOL)


def test_sp_checkpoints_cross_process_counts(launched):
    """The SP checkpoint written by 2 processes (layout b, after its 3
    steps; restored bitwise in both by the workers) holds every rank's
    generator and restores in one process bitwise; the one-process
    checkpoint written before the launch restored in 2 processes holds its
    parameters, state, step and each rank's generator, and the next step
    there equals the one-process run's."""
    out, _ = launched
    prefix = os.path.join(out, "sp-ckpt")
    with open(prefix + "-manifest.json") as f:
        assert json.load(f)["nprocs"] == 2
    for info in _json(out, "sp-ring_striped-b"):
        assert info["ckpt"]["step"] == W.LM_STEPS
    tr, _ = _sp_port("ring_striped", "b")
    # every rank's generator, from both processes' files
    flat = load_sharded(prefix)[0]
    rows = [flat["rng/%d" % r] for r in range(5)]
    fresh, _ = _sp_port("ring_striped", "b", steps=0)
    for g in fresh._generators().values():
        torch.rand(1, generator=g)
    fresh.restore_sharded_checkpoint(prefix)
    assert fresh._t == W.LM_STEPS
    _equal(W.sp_state(fresh), _npz(out, "sp-ring_striped-b")[0],
           "2-process checkpoint restored in one")
    for r, g in fresh._generators().items():
        assert torch.equal(g.get_state(), rows[r])
        assert torch.equal(rows[r], tr._generators()[r].get_state())
    want = W.sp_state(tr)
    want.update({"rng:%d" % r: g.get_state().numpy()
                 for r, g in tr._generators().items()})
    for r, (got, info) in enumerate(zip(_npz(out, "sp-onep-restored"),
                                        _json(out, "sp-onep-restored"))):
        assert info["t"] == W.LM_STEPS
        mine = [2 * r, 2 * r + 1, 4]
        assert {k for k in got if k.startswith("rng:")} == {
            "rng:%d" % i for i in mine}
        _equal(got, {k: want[k] for k in got}, "onep restored, rank %d" % r)
    tr.step(W.lm_batch(W.SP_SIZES["tiny"]))
    for r, got in enumerate(_npz(out, "sp-onep-step")):
        _equal(got, W.sp_state(tr), "onep restored + 1 step, rank %d" % r)


def test_lm_dp_adafactor_fsdp_matches_one_process_and_jax(launched):
    """AdaFactor with fsdp across 2 processes x 2 ranks (its factored
    state leaves sharded over dp with the parameters, gathered from both
    processes before the update): both ranks bitwise the one-process
    4-rank run, the loss falling, a host stage gathering the shards
    before the captured update; within 2e-2 by norm of the JAX package's
    deltas."""
    out, _ = launched
    variant, kw = W.LM_ADAFACTOR
    cfg = W.LM_SIZES["tiny"]
    tr = W.lm_trainer(par, cfg, par.build_mesh({"dp": 4}, CPU4), **kw)
    init = {k: v.numpy() for k, v in tr.get_params()[0].items()}
    batch = W.lm_batch(cfg)
    steps = W.LM_DP_STEPS["tiny"]
    for _ in range(steps):
        tr.step(batch)
    want = _ranks_and_oracle(out, "lm_dp-" + variant, tr)
    assert any(k.startswith("opt:") for k in want)
    res = _json(out, "lm_dp-" + variant)
    for r in res:
        assert r["loss"][-1] < r["loss"][0]
        assert r["compile_counts"] == {"step.compute": 1, "step.update": 1}
        # gather_params, reduce, the per-weight gather, the output stage
        assert r["host_stages"] == 4
    assert res[0]["loss"] == res[1]["loss"]
    jsym = jax_lm(cfg["vocab"], num_layers=cfg["layers"],
                  embed_dim=cfg["embed"], num_heads=cfg["heads"],
                  impl="flash")
    jtr = jpar.ParallelTrainer(
        jsym, {k: v.shape for k, v in batch.items()},
        optimizer="adafactor", mesh=jpar.build_mesh({"dp": 4}), fsdp=True,
        optimizer_params={"learning_rate": W.LM_LR})
    jtr.init_params({k: jmx.nd.array(v) for k, v in init.items()})
    for _ in range(steps):
        jtr.step(batch)
    got = {k[4:]: v for k, v in want.items() if k.startswith("arg:")}
    jwant = {k: v.asnumpy() for k, v in jtr.get_params()[0].items()}
    # the key third of qkv_bias: its gradient is 0 in exact arithmetic (a
    # per-query constant in the scores, which the softmax cancels), and
    # AdaFactor's RMS normalization turns its rounding noise into steps of
    # lr x epsilon2 in either package: both held to that size, the q and
    # v thirds to the delta gate
    e = cfg["embed"]
    for name in [k for k in got if k.endswith("qkv_bias")]:
        for a in (got, jwant, init):
            a[name + ":k"] = a[name][e:2 * e]
            a[name] = np.concatenate([a[name][:e], a[name][2 * e:]])
        for a in (got, jwant):
            step = np.abs(a[name + ":k"] - init[name + ":k"]).max()
            assert 0 < step <= 4 * steps * W.LM_LR * 1e-3, (name, step)
        for a in (got, jwant, init):
            del a[name + ":k"]
    _delta_gate(variant, got, init, jwant)
