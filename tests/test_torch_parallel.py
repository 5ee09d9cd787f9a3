"""The port's data-parallel training against one process and against the
JAX package's mesh, on the CPU over gloo.

- ``local_row_block``, ``clamp_data_axis`` against ``mde_tpu.parallel``'s,
  case by case (the same values, or the same ValueError).
- ``HostLoader(process_shard=...)`` against mde_tpu's on a generated dataset
  of 11 samples in batches of 4 (a remainder of 3), shuffled: the same rows
  and ``_replicated`` tags a process. With two accumulation steps, each
  microbatch's rows over the processes, in order, are the JAX batch's
  microbatch (``mde_tpu/train/trainer.py:226-231``).
- ``mesh_world`` (and the examples' ``data_world``) and
  ``initialize_from_env``: the world a config and a launcher give, (data,
  model) as ``make_training_mesh`` gives it, the model axis taken for the
  BEiT, Swin V1/V2 and Next-ViT trunks too.
- Two gloo processes (``mde_tpu_torch.parallel.launch``: workers that import
  nothing of the JAX package), started once for the module:
  (a) the cross-process BatchNorm on 2 + 2 rows against ``nn.BatchNorm2d``
      on the 4, in float64, float32 and a bf16 input with float32 parameters
      (as autocast runs the layer): output, input gradient and running
      statistics at atol 1e-6, the weight and bias gradients (the processes'
      shares added) at atol 1e-6 in float64 and 2e-5 otherwise; a bf16
      output and input gradient within one bf16 rounding (``BN_TOL``);
  (b) three train steps of the small flagship (64x96, DINOv2 at 28x42,
      LayerScale gammas in [0.2, 0.8]) at global batch 4 with accumulation
      1 and 8 with accumulation 2, and a batch of 3 that runs replicated
      (``STEP_CASES``), with the real pipeline and generators, against the port's
      one-process step on the same batches and generators, in float64:
      losses at rel 1e-5, parameters and BN buffers at rel-L2 1e-5, and the
      same values on both processes;
  (c) three steps on the JAX train pipeline's outputs (the draws injected,
      as tests/test_torch_train.py's step-synced test does) against JAX's
      ``make_train_step`` over ``make_mesh(2, 1)`` on the virtual CPU
      devices, at that test's tolerances: losses at rtol 1e-4 and BN running
      statistics at rtol 1e-3, atol 1e-5 (torch's unbiased variance mapped
      from flax's biased one by n/(n-1));
  (d) ``fit`` and ``generate_test_predictions`` on generated data (a val
      batch and a test batch that do not split run replicated): one
      checkpoint, identical histories on both processes, equal to the
      one-process ``fit``'s at rel 1e-5, the checkpoint's weights at rel-L2
      1e-5, and one prediction a test image; then ``evaluate`` and
      ``evaluate_full_suite`` on the train loader (sharded) and the val one
      (replicated), at rel 1e-5.

Why float64 in (b) and a learning rate of 0 in (c) and (d): in float32 the
flagship's trajectory is chaotic after one AdamW step (the first update is
lr * sign(g), and the sign of a gradient that is rounding noise flips). The
one-process step itself, run with 1 and with 2 CPU threads, gives
second-step losses 3% apart, and the two-process step's first gradient is
0.75% (rel-L2) from the one-process one in float32 and 1.5e-13 in float64.
So (b) holds several real steps of two summation orders in float64, and (c)
and (d), which run float32 (JAX's and the epoch loop's), hold every step at
the same weights: the losses, the global BN statistics and their running
averages, the reductions, the replicated batches and the writes.
- The training CLI at W = 2 (``--device cpu``, it starts its two processes
  itself): one checkpoint, one log, the predictions.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.data import transforms as JT
from mde_tpu.data.dataset import DepthDataset as JDepthDataset
from mde_tpu.data.loader import HostLoader as JHostLoader
from mde_tpu.parallel import active_mesh, clamp_data_axis as jax_clamp, make_mesh, replicate
from mde_tpu.parallel import distributed as jax_dist
from mde_tpu.parallel import shard_batch
from mde_tpu.train import trainer as jax_trainer
from mde_tpu_torch.core import config
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.data.dataset import DepthDataset
from mde_tpu_torch.data.loader import HostLoader
from mde_tpu_torch.data.transforms import make_train_pipeline
from mde_tpu_torch.parallel import distributed, launch, mesh
from mde_tpu_torch.parallel.sync_batchnorm import convert_sync_batchnorm
from mde_tpu_torch.tools import main as train_cli
from mde_tpu_torch.tools.common import _override, build_loaders, resolve_paths
from mde_tpu_torch.train.checkpoint import load_training_checkpoint
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import (evaluate, evaluate_full_suite, fit,
                                         generate_test_predictions, make_optimizer,
                                         make_train_step, step_generator)
from tests.test_torch_train import SIZE, _cfg, flagship  # noqa: F401  (module fixture)

torch.set_num_threads(2)

WORLD = 2
STEPS = 3
TOL_STEP = 1e-5
# (rtol of the output and input gradient, atol of the output, input
# gradient and running statistics; atol of the weight and bias gradients):
# the float32 weight and bias gradients are sums of 84 terms up to about 3,
# whose rounding alone reaches 84 * 3 * 2^-24 = 1.5e-5. A bf16 output or
# input gradient is a float32 value rounded once to bf16: two float32 values
# a few ulps apart may round to neighbours, one bf16 ulp, at most 2^-7 of
# the value (atol 1e-5 for the float32 cancellation in the input gradient
# of values near 0); its statistics and parameter gradients are float32.
BN_TOL = {"float64": (0, 1e-6, 1e-6), "float32": (0, 1e-6, 2e-5),
          "bfloat16": (2 ** -7, 1e-5, 2e-5)}


# ---------------------------------------------------------------------------
# Row layouts and the world, against mde_tpu.parallel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,count", [(4, 2), (8, 4), (6, 3), (12, 1), (5, 2), (4, 3)])
def test_local_row_block_matches_jax(rows, count):
    for p in range(count):
        try:
            want = jax_dist.local_row_block(rows, p, count)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err)):
                distributed.local_row_block(rows, p, count)
        else:
            assert distributed.local_row_block(rows, p, count) == want


@pytest.mark.parametrize("requested,batch,devices", [(-1, 4, 8), (-1, 6, 4), (3, 4, 8), (2, 4, 1),
                                                     (-1, 7, 4), (5, 10, 8), (8, 12, 8)])
def test_clamp_data_axis_matches_jax(requested, batch, devices):
    assert mesh.clamp_data_axis(requested, batch, devices) == jax_clamp(requested, batch, devices)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_data")
    synthetic.generate(str(root), n_train=11, n_test=0, size=(6, 8), seed=3)
    return root


def _datasets(root):
    args = (str(root / "train"), str(root / "train_list.txt"))
    return DepthDataset(*args), JDepthDataset(*args)


@pytest.mark.parametrize("count,tags", [(2, [False, False, True]), (3, [True, True, False])])
def test_process_shard_matches_jax_loader(dataset_root, count, tags):
    """Accumulation 1: each process's rows and tags are mde_tpu's (4, 4, 3
    rows: over 3 processes only the remainder splits)."""
    ds, jds = _datasets(dataset_root)
    for p in range(count):
        got = list(HostLoader(ds, batch_size=4, shuffle=True, seed=5, num_workers=2,
                              process_shard=(p, count)))
        want = list(JHostLoader(jds, batch_size=4, shuffle=True, seed=5, num_workers=2,
                                use_native=False, process_shard=(p, count)))
        assert [b["names"] for b in got] == [b["names"] for b in want]
        assert [b.get("_replicated", False) for b in got] == \
            [b.get("_replicated", False) for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["rgb"], w["rgb"])
            np.testing.assert_array_equal(g["depth"], w["depth"])
    assert [b.get("_replicated", False) for b in want] == tags


@pytest.mark.parametrize("batch,count,accum", [(4, 2, 2), (8, 2, 2), (12, 3, 2), (8, 2, 4),
                                               (6, 2, 2)])
def test_accumulation_layout_holds_each_microbatch_share(dataset_root, batch, count, accum):
    """Microbatch i of the JAX step is global rows [i m, (i + 1) m); process
    p holds its p-th share of each, in order. A batch whose microbatches do
    not split over the processes (6 rows, 2 microbatches of 3) runs
    replicated."""
    ds, jds = _datasets(dataset_root)
    want = list(JHostLoader(jds, batch_size=batch, shuffle=True, seed=2, num_workers=1,
                            use_native=False))
    got = [list(HostLoader(ds, batch_size=batch, shuffle=True, seed=2, num_workers=1,
                           process_shard=(p, count), accum_steps=accum))
           for p in range(count)]
    for i, w in enumerate(want):
        names = w["names"]
        m = len(names) // accum if len(names) % accum == 0 else None
        if m is None or m % count:
            assert all(g[i]["_replicated"] and g[i]["names"] == names for g in got)
            continue
        per = m // count
        for j in range(accum):
            micro = [n for g in got for n in g[i]["names"][j * per:(j + 1) * per]]
            assert micro == names[j * m:(j + 1) * m], (i, j)
        assert not any(g[i].get("_replicated", False) for g in got)


def test_data_world_clamps_and_refuses_the_model_axis(monkeypatch):
    """``mesh_world``'s contract (it took ``data_world``'s place): the data
    axis clamped as before and (data, model) as ``make_training_mesh`` gives
    them, usable cards = cards // model; the model axis taken for the
    flagship and for a BEiT, a Swin V1, a Swin V2 and the Next-ViT trunk
    (the test keeps the name it had when it checked their refusal)."""
    cfg = config.defaults()
    cfg.training.batch_size = 6
    for requested, device, want in ((-1, "cpu", 1), (4, "cpu", 3), (2, "cuda:0", 2),
                                    (1, "cpu", 1)):
        cfg.framework.mesh.data = requested
        assert mesh.mesh_world(cfg, device) == (want, 1), (requested, device)
        assert mesh.data_world(cfg, device) == want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(jax, "devices", lambda: list(range(4)))
    cfg.framework.mesh.data = -1
    assert mesh.mesh_world(cfg, "cuda") == (3, 1)
    jcfg = jax_config.defaults()
    jcfg.framework.mesh.data = -1
    for model, batch in ((2, 6), (2, 4), (4, 6)):
        cfg.framework.mesh.model = jcfg.framework.mesh.model = model
        cfg.training.batch_size = batch
        with monkeypatch.context() as m:
            m.setattr("mde_tpu.parallel.mesh.make_mesh", lambda data, model: (data, model))
            from mde_tpu.parallel.mesh import make_training_mesh

            want = make_training_mesh(jcfg, batch)
        assert mesh.mesh_world(cfg, "cuda") == want, (model, batch)
    cfg.framework.mesh.model = 2
    assert mesh.mesh_world(cfg, "cpu") == (1, 2)
    with pytest.raises(ValueError, match="examples"):
        mesh.data_world(cfg, "cpu")
    for name in ("dpt_beit_base_384", "dpt_swin_large_384", "dpt_swin2_tiny_256",
                 "dpt_next_vit_large_384"):
        cfg.model.model_type = name
        assert mesh.mesh_world(cfg, "cpu") == (1, 2), name


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"MDE_DIST_COORDINATOR": "127.0.0.1:1234", "MDE_DIST_NUM_PROCESSES": "2",
      "MDE_DIST_PROCESS_ID": "1", "MDE_DIST_CPU": "1"}, ("tcp://127.0.0.1:1234", 2, 1, "cpu")),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1",
      "MASTER_PORT": "1"}, ("env://", 4, 3, "cpu")),
])
def test_initialize_from_env_reads_the_launchers(monkeypatch, env, want):
    for name in ("MDE_DIST_COORDINATOR", "MDE_DIST_NUM_PROCESSES", "MDE_DIST_PROCESS_ID",
                 "MDE_DIST_CPU", "MDE_DIST_BACKEND", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(distributed, "initialize",
                        lambda method, n, p, device, backend: seen.append(
                            (method, n, p, device.type)))
    assert distributed.initialize_from_env("cpu") is (want is not None)
    assert seen == ([want] if want else [])


# ---------------------------------------------------------------------------
# Two gloo processes
# ---------------------------------------------------------------------------

SETS = ["framework.input_size=[64,96]", "framework.native_size=[64,96]",
        "framework.compute_dtype=float32", "model.loss_function.si_loss_alpha=1.0",
        "model.loss_function.silog_loss.alpha=0.3",
        "model.loss_function.silog_loss.variance_focus=0.85",
        "model.loss_function.grad_loss_alpha=0.2", "model.loss_function.edge_loss_alpha=0.1"]


def _global_batches(seed, n, rows=4, shape=(60, 80)):
    rng = np.random.default_rng(seed)
    return [{"rgb": rng.integers(0, 256, (rows, *shape, 3), dtype=np.uint8),
             "depth": rng.uniform(0.5, 5.0, (rows, *shape)).astype(np.float32)}
            for _ in range(n)]


# (b)'s global batch a step: with accumulation 2, 8 rows, so that a process's
# microbatch holds 2 rows as with accumulation 1. K4's plain version (the
# DINOv2 attention) computes in float32 even in a float64 model, and the
# CPU's float32 products of a batch of one row round differently from those
# of two (1.3e-7 at the first block), which the flagship amplifies to 1.5e-4
# in the first gradient.
# A batch of 3 does not split over 2: it runs whole on both processes
# (``replicated``), with local BN statistics.
STEP_CASES = {"accum1": (1, 4), "accum2": (2, 8), "replicated": (1, 3)}


def _jax_pipeline_batches():
    """Post-pipeline global batches from JAX's train pipeline (NHWC)."""
    out = []
    for i, b in enumerate(_global_batches(31, STEPS)):
        rgb, depth = JT.make_train_pipeline(False, SIZE)(jax.random.key(100 + i),
                                                         jnp.asarray(b["rgb"]),
                                                         jnp.asarray(b["depth"]))
        out.append({"rgb": np.asarray(rgb), "depth": np.asarray(depth)})
    return out


def _bn_input(dtype):
    """x and dy in ``dtype``; the layer's parameters in float32 beside bf16."""
    g = torch.Generator().manual_seed(0)
    bn = torch.nn.BatchNorm2d(5).to(torch.float32 if dtype == torch.bfloat16 else dtype)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_mean.uniform_(-0.5, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    return {"x": (torch.randn(4, 5, 3, 7, generator=g) * 2 + 0.5).to(dtype),
            "dy": torch.randn(4, 5, 3, 7, generator=g).to(dtype), "state_dict": bn.state_dict()}


def _fit_sets(root, tag):
    return SETS + ["framework.learning_rate=0",f"paths.data_dir={root / 'data'}", f"paths.results_dir={root / tag / 'results'}",
                   f"paths.predictions_dir={root / tag / 'predictions'}",
                   "training.n_epoch=2", "framework.num_workers=1", "experiment.wandb_disable=true"]


@pytest.fixture(scope="module")
def ranks(flagship, tmp_path_factory):  # noqa: F811
    """Every job of (a)-(d) in one start of two gloo processes."""
    root = tmp_path_factory.mktemp("parallel")
    torch.save(flagship[3], root / "model.pt")
    for dtype in BN_TOL:
        torch.save(_bn_input(getattr(torch, dtype)), root / f"bn_{dtype}.pt")
    for case, (_, rows) in STEP_CASES.items():
        torch.save(_global_batches(7, STEPS, rows), root / f"batches_{case}.pt")
    given = [{"rgb": b["rgb"].transpose(0, 3, 1, 2).copy(), "depth": b["depth"]}
             for b in _jax_pipeline_batches()]
    torch.save(given, root / "given.pt")
    synthetic.generate(str(root / "data"), n_train=14, n_test=5, size=(60, 80), seed=4)
    gens = [[0, 0, i] for i in range(STEPS)]
    jobs = [{"name": f"bn_{dtype}", "mode": "batchnorm", "input": str(root / f"bn_{dtype}.pt")}
            for dtype in BN_TOL]
    step = {"mode": "steps", "model": str(root / "model.pt"), "generators": gens}
    for case, (accum, _) in STEP_CASES.items():
        jobs.append({**step, "name": f"steps_{case}", "accum": accum, "sets": SETS,
                     "batches": str(root / f"batches_{case}.pt"), "float64": True})
    for accum in (1, 2):
        jobs.append({**step, "name": f"given{accum}", "accum": accum, "given": True,
                     "batches": str(root / "given.pt"),
                     "sets": SETS + ["framework.learning_rate=0"]})
    jobs.append({"name": "fit", "mode": "fit", "model": str(root / "model.pt"),
                 "sets": _fit_sets(root, "ranks")})
    spec = {"world": WORLD, "device": "cpu", "out": str(root), "threads": 2, "jobs": jobs}
    out = launch.run(spec, str(root / "spec.json"), timeout=600)
    yield root, out
    shutil.rmtree(root, ignore_errors=True)  # about 1.5 GB of models and checkpoints


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _rel_l2(got: dict, want: dict, keys) -> float:
    g = torch.cat([got[k].double().flatten() for k in keys])
    w = torch.cat([want[k].double().flatten() for k in keys])
    return ((g - w).norm() / w.norm()).item()


def test_ranks_ran_over_gloo_on_the_cpu(ranks):
    _, out = ranks
    for job in out.values():
        assert [r["rank"] for r in job] == list(range(WORLD))
        assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in job)


@pytest.mark.parametrize("dtype", sorted(BN_TOL))
def test_sync_batchnorm_matches_batchnorm_on_the_global_batch(ranks, dtype):
    root, out = ranks
    rtol, atol, atol_sums = BN_TOL[dtype]
    data = torch.load(root / f"bn_{dtype}.pt", weights_only=True)
    bn = torch.nn.BatchNorm2d(5).to(data["state_dict"]["weight"].dtype)
    bn.load_state_dict(data["state_dict"])
    x = data["x"].clone().requires_grad_(True)
    y = bn.train()(x)
    y.backward(data["dy"])
    r = out[f"bn_{dtype}"]
    assert all(a["y"].dtype == getattr(torch, dtype) for a in r)
    assert all(a["dx"].dtype == getattr(torch, dtype) for a in r)
    np.testing.assert_allclose(torch.cat([a["y"] for a in r]).double().numpy(),
                               y.detach().double().numpy(), atol=atol, rtol=rtol)
    np.testing.assert_allclose(torch.cat([a["dx"] for a in r]).double().numpy(),
                               x.grad.double().numpy(), atol=atol, rtol=rtol)
    for key, grad in (("dw", bn.weight.grad), ("db", bn.bias.grad)):
        np.testing.assert_allclose(sum(a[key] for a in r).numpy(), grad.numpy(),
                                   atol=atol_sums, rtol=0, err_msg=key)
    for a in r:
        for k, v in bn.state_dict().items():
            np.testing.assert_allclose(a["state_dict"][k].numpy(), v.numpy(), atol=atol, rtol=0,
                                       err_msg=k)


def test_sync_batchnorm_in_a_group_of_one_runs_its_all_reduce_form(monkeypatch):
    """In a process group of one (the smoke run's world of one over NCCL,
    its noise witness) the layer runs its cross-process form: two
    all-reduces forward and one backward, which change nothing, so it is
    ``nn.BatchNorm2d`` within float64 rounding (atol 1e-12); without a
    group it is ``nn.BatchNorm2d`` itself and calls none."""
    data = _bn_input(torch.float64)
    calls = []
    all_reduce = torch.distributed.all_reduce
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, *a, **k: calls.append(t.shape) or all_reduce(t, *a, **k))

    def run(layer):
        layer.load_state_dict(data["state_dict"])
        x = data["x"].clone().requires_grad_(True)
        y = layer.train()(x)
        y.backward(data["dy"])
        return [y.detach(), x.grad, layer.weight.grad, layer.bias.grad,
                layer.running_mean, layer.running_var]

    want = run(torch.nn.BatchNorm2d(5).double())
    alone = run(convert_sync_batchnorm(torch.nn.BatchNorm2d(5).double()))
    assert not calls and all(torch.equal(a, w) for a, w in zip(alone, want))
    distributed.initialize(f"tcp://127.0.0.1:{launch.free_port()}", 1, 0, torch.device("cpu"))
    try:
        got = run(convert_sync_batchnorm(torch.nn.BatchNorm2d(5).double()))
    finally:
        distributed.shutdown()
    assert len(calls) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=1e-12, rtol=0)


def _port_cfg(sets):
    """The default config with the ``--set`` overrides the workers apply."""
    cfg = config.defaults()
    for item in sets:
        _override(cfg, item)
    return cfg


def _one_process_steps(port, accum, batches):
    """The port's one-process steps on the global batches, in float64."""
    cfg = _port_cfg(SETS)
    model = copy.deepcopy(port).double()
    with launch.train_pipeline(launch.float64_pipeline(make_train_pipeline(False, SIZE))):
        step = make_train_step(model, cfg, make_optimizer(model, cfg), accum_steps=accum)
    losses = [{k: v.item() for k, v in step(torch.from_numpy(b["rgb"]),
                                            torch.from_numpy(b["depth"]),
                                            step_generator(0, 0, i)).items()}
              for i, b in enumerate(batches)]
    return losses, model.state_dict()


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_process_steps_equal_the_one_process_step(ranks, flagship, case):  # noqa: F811
    root, out = ranks
    accum = STEP_CASES[case][0]
    batches = torch.load(root / f"batches_{case}.pt", weights_only=False)
    losses, state = _one_process_steps(flagship[3], accum, batches)
    r = out[f"steps_{case}"]
    assert r[0]["losses"] == r[1]["losses"]  # the global loss on both
    assert r[0]["fingerprint"] == r[1]["fingerprint"]  # the same weights on both
    for got, want in zip(r[0]["losses"], losses):
        for k in want:
            assert _rel(got[k], want[k]) < TOL_STEP, (k, got[k], want[k])
    keys = [k for k, v in r[0]["state_dict"].items() if v.is_floating_point()]
    assert _rel_l2(r[0]["state_dict"], state, keys) < TOL_STEP
    moved = [k for k in keys if not torch.equal(state[k], flagship[3].state_dict()[k].double())]
    assert len(moved) > 100
    bn = "fusion_head.2.num_batches_tracked"
    assert r[0]["state_dict"][bn].item() == flagship[3].state_dict()[bn].item() + STEPS * accum


@pytest.mark.parametrize("accum", [1, 2])
def test_two_process_steps_match_jax_mesh_step(ranks, flagship, accum, monkeypatch):  # noqa: F811
    root, out = ranks
    jm, params, stats, port = flagship
    jcfg = _cfg(jax_config)
    jcfg.framework.learning_rate = 0.0  # every step at the same weights (module docstring)
    batches = _jax_pipeline_batches()  # before the pipeline is replaced below
    monkeypatch.setattr(JT, "make_train_pipeline",
                        lambda augmentation, size: lambda key, rgb, depth: (rgb, depth))
    jmesh = make_mesh(WORLD, 1)
    tx = jax_trainer.make_optimizer(jcfg, params)
    state = jax_trainer.TrainState(
        step=jnp.asarray(0, jnp.int32), params=replicate(params, jmesh),
        batch_stats=replicate(stats, jmesh), opt_state=replicate(tx.init(params), jmesh), tx=tx)
    # No mesh registered for the windowed attention: its XLA form, which GSPMD
    # partitions over the sharded batch (the Pallas form under shard_map does
    # not take this 8x12 reduced grid).
    with active_mesh(None):
        step = jax_trainer.make_train_step(jm, jcfg, accum_steps=accum)
        losses = []
        for i, b in enumerate(batches):
            sharded = shard_batch(b, jmesh)
            state, metrics = step(state, jax.random.key(i), sharded["rgb"], sharded["depth"])
            losses.append(float(metrics["loss"]))
    got = out[f"given{accum}"][0]
    for g, w in zip(got["losses"], losses):
        np.testing.assert_allclose(g["loss"], w, rtol=1e-4)
    # BN running statistics after k momentum updates of 0.1 (STEPS * accum,
    # twice that for the cross-attention's reduction, which runs on both of
    # its inputs): torch's variance updates are n/(n-1) times flax's (n per
    # microbatch)
    new = state_dict_from_flax({}, jax.device_get(state.batch_stats))
    old = port.state_dict()
    sd = got["state_dict"]
    n_rows = 4 // accum
    checked = 0
    for name in (key[:-len(".running_var")] for key in new if key.endswith("running_var")):
        mean_k, var_k = f"{name}.running_mean", f"{name}.running_var"
        np.testing.assert_allclose(sd[mean_k].numpy(), new[mean_k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=mean_k)
        n = n_rows * _bn_pixels(port, name)
        k = int(sd[f"{name}.num_batches_tracked"] - old[f"{name}.num_batches_tracked"])
        assert k in (STEPS * accum, 2 * STEPS * accum), (name, k)
        decayed = 0.9 ** k * old[var_k].double()
        want = decayed + (new[var_k].double() - decayed) * n / (n - 1)
        np.testing.assert_allclose(sd[var_k].numpy(), want.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=var_k)
        checked += 1
    assert checked > 20


_PIXELS: dict = {}


def _bn_pixels(port, name):
    """H*W at BN layer ``name`` for a 64x96 input."""
    if not _PIXELS:
        hooks = [m.register_forward_hook(
            lambda mod, args, out, n=n: _PIXELS.__setitem__(n, args[0].shape[2] * args[0].shape[3]))
            for n, m in port.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
        model = copy.deepcopy(port).eval()
        with torch.no_grad():
            model(torch.zeros(1, 3, *SIZE))
        for h in hooks:
            h.remove()
    return _PIXELS[name]


def test_two_process_fit_equals_the_one_process_fit(ranks, flagship):  # noqa: F811
    root, out = ranks
    cfg = _port_cfg(_fit_sets(root, "one"))
    model = copy.deepcopy(flagship[3])
    paths = resolve_paths(cfg)
    loaders = build_loaders(cfg, paths)
    want = fit(model, cfg, make_optimizer(model, cfg), loaders["train"], loaders["val"],
               paths["results_dir"], seed=int(cfg.framework.seed))
    assert generate_test_predictions(model, cfg, loaders["test"], paths["predictions_dir"]) == 5
    fresh = build_loaders(cfg, paths)
    metrics = {"evaluate": evaluate(model, cfg, fresh["train"]),
               "suite": {split: evaluate_full_suite(model, cfg, fresh[split])
                         for split in ("train", "val")}}

    r = out["fit"]
    h0, h1 = r[0]["history"], r[1]["history"]
    for key in ("train_loss", "val_loss", "n_train"):
        assert h0[key] == h1[key], key
        assert len(h0[key]) == 2
        for g, w in zip(h0[key], want[key]):
            assert _rel(g, w) < TOL_STEP, (key, g, w)
    # the train loader's batches are sharded, the val loader's replicated
    assert all(rank["evaluate"] == r[0]["evaluate"] and rank["suite"] == r[0]["suite"]
               for rank in r)
    for key, want_m in (("evaluate", metrics["evaluate"]), ("train", metrics["suite"]["train"]),
                        ("val", metrics["suite"]["val"])):
        for rank in r:
            got_m = rank["evaluate"] if key == "evaluate" else rank["suite"][key]
            assert set(got_m) == set(want_m)
            for k in want_m:
                assert _rel(got_m[k], want_m[k]) < TOL_STEP, (key, k, got_m[k], want_m[k])
    ckpts = os.listdir(root / "ranks" / "results")
    assert [c for c in ckpts if c.endswith(".pth")] == [c for c in os.listdir(paths["results_dir"])
                                                        if c.endswith(".pth")]
    assert len([c for c in ckpts if c.endswith(".pth")]) == 1
    name = [c for c in ckpts if c.endswith(".pth")][0]
    got = load_training_checkpoint(str(root / "ranks" / "results" / name))
    ref = load_training_checkpoint(os.path.join(paths["results_dir"], name))
    keys = [k for k, v in ref["model_state_dict"].items() if v.is_floating_point()]
    assert _rel_l2(got["model_state_dict"], ref["model_state_dict"], keys) < TOL_STEP
    assert got["epoch"] == ref["epoch"] and _rel(got["val_loss"], ref["val_loss"]) < TOL_STEP
    # 5 test images in batches of 4: rank p writes 2 of the first, rank 0 the last one
    assert [a["written"] for a in r] == [3, 2]
    preds = sorted(os.listdir(root / "ranks" / "predictions"))
    assert preds == sorted(os.listdir(paths["predictions_dir"])) and len(preds) == 5
    for p in preds:
        np.testing.assert_allclose(np.load(root / "ranks" / "predictions" / p),
                                   np.load(os.path.join(paths["predictions_dir"], p)),
                                   rtol=1e-4, atol=1e-4)


def test_training_cli_starts_two_processes(tmp_path):
    """5 samples: 4 train (two steps of 2), 1 val and 3 test (a batch of 2
    and a replicated remainder)."""
    synthetic.generate(str(tmp_path / "data"), n_train=5, n_test=3, size=(60, 80), seed=1)
    argv = ["--device", "cpu", "--data-dir", str(tmp_path / "data"),
            "--set", "framework.input_size=[64, 96]", "--set", "framework.native_size=[60, 80]",
            "--set", "training.batch_size=2", "--set", "framework.num_workers=1",
            "--set", "framework.mesh.data=2", "--set", "training.n_epoch=1",
            "--set", f"paths.results_dir={tmp_path / 'results'}",
            "--set", f"paths.predictions_dir={tmp_path / 'predictions'}"]
    assert train_cli.main(argv) is None  # the ranks ran in their own processes
    results = sorted(os.listdir(tmp_path / "results"))
    assert [f for f in results if f.endswith(".pth")] == \
        ["best_model_midas_semantics_cross_attention_no_lb.pth"]
    assert len([f for f in results if f.endswith(".log.jsonl")]) == 1  # rank 0's logger alone
    preds = sorted(os.listdir(tmp_path / "predictions"))
    assert preds == [f"test_{i:06d}_depth.npy" for i in range(3)]
    assert all(np.load(tmp_path / "predictions" / p).shape == (60, 80) for p in preds)
