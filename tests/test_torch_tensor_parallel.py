"""The port's tensor parallelism (``parallel/tensor.py``, the model axis of
``parallel/mesh.py``) against one process and against the JAX package's
(data, model) mesh, on the CPU over gloo.

Without processes:
  (2) ``gather_state_dict`` of the ranks' ``shard_state_dict`` shares is the
      state_dict bit for bit, for the flagship, DA-V2 vits and DPT_Large
      (vitl16_384 narrowed to 64 wide, 4 heads), at T = 2 and 4; each
      share of a sharded tensor is 1/T of it, and a fused qkv share holds
      its rank's heads of each of q, k and v;
  (3) the port's sharded keys (``tp_layout``) equal the leaves
      ``mde_tpu.parallel.tp_param_spec`` shards at T = 2 on the same model's
      JAX tree, carried into the port's grammar by ``state_dict_from_flax``
      (sharded leaves filled with ones, the rest with zeros), for the same
      three models; every sharded attention holds whole heads.

Over gloo (``mde_tpu_torch.parallel.launch``), two starts: four ranks, then
two ranks, each job over its own (data, model) split:
  (1) a ViT ``Mlp`` through ``tensor_parallel`` at T = 2 (fc1
      ``ColumnParallelLinear``, fc2 ``RowParallelLinear``) and
      ``gather_from_model`` of fc1's output against the one-process layers in
      float64: output, input gradient, fc1's output and the parameters'
      gradients gathered, at atol 1e-12; the row bias is whole on each rank;
  (4) one flagship step (64x96, DINOv2 at 28x42, LayerScale gammas in [0.2,
      0.8]) at (1, 2) and (2, 2) against the port's one-process step on the
      same global batch of 4 and generator, in float64 at the config's
      learning rate: loss at rel 1e-5, the gathered gradient and the gathered
      state at rel-L2 1e-5 (the bound ``test_torch_parallel`` holds two data
      ranks to), the same on every rank, and each rank's parameter bytes at
      the layout's share; then the (2, 2) step on the JAX train pipeline's
      outputs, float32 at learning rate 0, against JAX's ``make_train_step``
      over ``make_mesh(2, 2)`` with ``shard_params_tp``'s layout: loss at
      rtol 1e-4, the tolerance of
      ``test_torch_parallel::test_two_process_steps_match_jax_mesh_step``;
  (5) one DA-V2 vits step (full width at 56x84) at (1, 2) against one
      process, as (4);
  (6) the cross-process BatchNorm at (1, 2) over the data group against
      ``nn.BatchNorm2d`` on the batch (atol 1e-12), and over the world, which
      counts each row twice: the same mean, variance and output, and a
      running variance whose unbiased correction is 2n / (2n - 1) in place
      of n / (n - 1);
  (7) the (2, 2) step's sharded checkpoint restored at (1, 2), at (2, 1) and
      in one process: identical parameters, buffers and AdamW moments, then
      one more step each, its loss at rel 1e-5 across the three.
(8) The training CLI at ``framework.mesh.model=2`` on ``--device cpu`` (it
starts its two ranks itself): one checkpoint, in the full reference grammar,
which loads into a one-process model with every key and shape; one log;
the predictions.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.data import transforms as JT
from mde_tpu.models import MidasNetSemantics as JMidasNetSemantics
from mde_tpu.models.depth_anything import DepthAnythingV2 as JDepthAnythingV2
from mde_tpu.models.dpt import DPTDepthModel as JDPT
from mde_tpu.nn import vit as jvit
from mde_tpu.parallel import (active_mesh, make_mesh, replicate, shard_batch, shard_params_tp,
                              tp_param_spec)
from mde_tpu.train import trainer as jax_trainer
from mde_tpu.core import config as jax_config
from mde_tpu_torch.core import config
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.data.transforms import make_train_pipeline
from mde_tpu_torch.models.depth_anything import DepthAnythingV2
from mde_tpu_torch.models.dpt import DPTDepthModel
from mde_tpu_torch.models.factory import build_module
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.nn import vit
from mde_tpu_torch.nn.vit import Mlp
from mde_tpu_torch.parallel import launch
from mde_tpu_torch.parallel.mesh import tp_layout
from mde_tpu_torch.parallel.tensor import gather_state_dict, shard_state_dict
from mde_tpu_torch.tools import main as train_cli
from mde_tpu_torch.tools.common import _override
from mde_tpu_torch.train.checkpoint import (load_checkpoint_sharded, load_state_dict,
                                            load_training_checkpoint)
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import make_optimizer, make_train_step, step_generator
from tests.test_torch_train import DINO, SIZE, _cfg, flagship  # noqa: F401  (module fixture)

torch.set_num_threads(2)

TOL_STEP = 1e-5
NARROW_VITL = (64, 24, 4, 16)  # vitl16_384 at its depth and hooks, 64 wide, 4 heads
DA2_SIZE = (56, 84)


@pytest.fixture
def narrow_vitl(monkeypatch):
    monkeypatch.setitem(jvit.VIT_CONFIGS, "vitl16_384", NARROW_VITL)
    monkeypatch.setitem(vit.VIT_CONFIGS, "vitl16_384", NARROW_VITL)


# (port module, JAX module, state_dict_from_flax's rules, JAX input (h, w))
MODELS = {
    "flagship": (lambda: MidasNetSemantics(dinov2_image_size=DINO),
                 lambda: JMidasNetSemantics(dinov2_image_size=DINO), "MidasNetSemantics", SIZE),
    "da2_vits": (lambda: DepthAnythingV2("vits"), lambda: JDepthAnythingV2(size="vits"),
                 "DepthAnythingV2", DA2_SIZE),
    "dpt_large": (lambda: DPTDepthModel("vitl16_384"), lambda: JDPT(backbone="vitl16_384"),
                  "DPTDepthModel", (64, 96)),
}


def _port(name):
    """The port's model with weights from a seed (gammas in [0.2, 0.8])."""
    model = build_module(lambda: MODELS[name][0](), {}, "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.endswith("gamma"):
                p.copy_(torch.rand(p.shape, generator=g, dtype=p.dtype) * 0.6 + 0.2)
    return model


# ---------------------------------------------------------------------------
# (2), (3): the layout, without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_gather_inverts_shard_bit_for_bit(name, size, narrow_vitl):
    model = _port(name)
    sd = model.state_dict()
    layout = tp_layout(model, size)
    shares = [shard_state_dict(sd, layout, size, r) for r in range(size)]
    back = gather_state_dict(shares, layout)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    sharded = [k for k, v in layout.items() if v != "replicated"]
    assert sharded
    for k in sharded:
        assert all(s[k].numel() * size == sd[k].numel() for s in shares), k
    for k in (k for k in sharded if k.endswith("qkv.weight")):
        heads = next(m.num_heads for n, m in model.named_modules() if f"{n}.qkv.weight" == k)
        dim = sd[k].shape[1]
        full = sd[k].reshape(3, heads, dim // heads, dim)
        per = heads // size
        for r, s in enumerate(shares):
            assert torch.equal(s[k].reshape(3, per, dim // heads, dim),
                               full[:, r * per:(r + 1) * per]), (k, r)


def _jax_sharded_keys(name, size):
    """The port keys of the leaves tp_param_spec shards, through
    state_dict_from_flax: sharded leaves as ones, the rest as zeros."""
    _, jfn, rules, hw = MODELS[name]
    shapes = jax.eval_shape(lambda k: jfn().init(k, jnp.zeros((1, *hw, 3))), jax.random.key(0))

    def mark(tree, path=()):
        if hasattr(tree, "items"):
            return {k: mark(v, path + (k,)) for k, v in tree.items()}
        spec = tp_param_spec(path, tree.shape, size)
        return np.full(tree.shape, float(any(a is not None for a in spec)), np.float32)

    sd = state_dict_from_flax(mark(shapes["params"]),
                              mark(shapes.get("batch_stats", {}), ("stats",)), rules)
    ones = {k for k, v in sd.items() if v.numel() and bool((v == 1).all())}
    mixed = [k for k, v in sd.items() if v.numel() and 0 < float(v.sum()) < v.numel()]
    assert not mixed, mixed
    return ones


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sharded_keys_equal_tp_param_spec(name, narrow_vitl):
    with torch.device("meta"):
        model = MODELS[name][0]()
    layout = tp_layout(model, 2)
    ours = {k for k, v in layout.items() if v != "replicated"}
    assert ours == _jax_sharded_keys(name, 2)
    for prefix, module in model.named_modules():
        if hasattr(module, "num_heads") and f"{prefix}.proj.weight" in ours:
            assert module.num_heads % 2 == 0, prefix


# ---------------------------------------------------------------------------
# Gloo ranks
# ---------------------------------------------------------------------------

SETS = ["framework.input_size=[64,96]", "framework.native_size=[64,96]",
        "framework.compute_dtype=float32", "model.loss_function.si_loss_alpha=1.0",
        "model.loss_function.silog_loss.alpha=0.3",
        "model.loss_function.silog_loss.variance_focus=0.85",
        "model.loss_function.grad_loss_alpha=0.2", "model.loss_function.edge_loss_alpha=0.1"]
DA2_SETS = SETS + ["model.model_type=DepthAnythingV2_vits", "framework.input_size=[56,84]",
                   "framework.native_size=[56,84]"]


def _global_batches(seed, n, rows=4, shape=(60, 80)):
    rng = np.random.default_rng(seed)
    return [{"rgb": rng.integers(0, 256, (rows, *shape, 3), dtype=np.uint8),
             "depth": rng.uniform(0.5, 5.0, (rows, *shape)).astype(np.float32)}
            for _ in range(n)]


def _jax_pipeline_batch():
    """One post-pipeline global batch from JAX's train pipeline (NHWC)."""
    b = _global_batches(31, 1)[0]
    rgb, depth = JT.make_train_pipeline(False, SIZE)(jax.random.key(100), jnp.asarray(b["rgb"]),
                                                     jnp.asarray(b["depth"]))
    return np.asarray(rgb), np.asarray(depth)


def _mlp_input():
    g = torch.Generator().manual_seed(0)
    mlp = Mlp(8, 32).double()
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64) * 0.5)
    return {"state_dict": mlp.state_dict(),
            "x": torch.randn(2, 5, 8, generator=g, dtype=torch.float64),
            "dy": torch.randn(2, 5, 8, generator=g, dtype=torch.float64)}


def _bn_input():
    g = torch.Generator().manual_seed(0)
    bn = torch.nn.BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_mean.uniform_(-0.5, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    return {"x": (torch.randn(4, 5, 3, 7, generator=g, dtype=torch.float64) * 2 + 0.5),
            "dy": torch.randn(4, 5, 3, 7, generator=g, dtype=torch.float64),
            "state_dict": bn.state_dict()}


def _da2():
    model = _port("da2_vits")
    with torch.no_grad():
        model.depth_head.scratch.output_conv2[2].bias.add_(0.5)
    return model


@pytest.fixture(scope="module")
def ranks(flagship, tmp_path_factory):  # noqa: F811
    """Every job of (1) and (4)-(7): four gloo ranks, then two."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    torch.save(flagship[3], root / "flagship.pt")
    torch.save(_da2(), root / "da2.pt")
    torch.save(_mlp_input(), root / "mlp.pt")
    torch.save(_bn_input(), root / "bn.pt")
    batches = _global_batches(7, 2)
    torch.save(batches[:1], root / "first.pt")
    torch.save(batches[1:], root / "second.pt")
    rgb, depth = _jax_pipeline_batch()
    torch.save([{"rgb": rgb.transpose(0, 3, 1, 2).copy(), "depth": depth}], root / "given.pt")
    step = {"mode": "steps", "generators": [[0, 0, 0]], "grads": True}
    flag = {**step, "model": str(root / "flagship.pt"), "sets": SETS}
    four = [{**flag, "name": "tp22", "model_axis": 2, "batches": str(root / "first.pt"),
             "float64": True, "save_sharded": str(root / "sharded")},
            {**flag, "name": "tp22_given", "model_axis": 2, "batches": str(root / "given.pt"),
             "given": True, "sets": SETS + ["framework.learning_rate=0"]}]
    restore = {**flag, "batches": str(root / "second.pt"), "generators": [[0, 0, 1]],
               "float64": True, "restore": str(root / "sharded")}
    two = [{"name": "mlp", "mode": "mlp", "model_axis": 2, "input": str(root / "mlp.pt")},
           {"name": "bn_data", "mode": "batchnorm", "model_axis": 2, "input": str(root / "bn.pt")},
           {"name": "bn_world", "mode": "batchnorm", "model_axis": 2, "input": str(root / "bn.pt"),
            "over_world": True},
           {**flag, "name": "tp12", "model_axis": 2, "batches": str(root / "first.pt"),
            "float64": True},
           {**step, "name": "da2", "model_axis": 2, "model": str(root / "da2.pt"),
            "sets": DA2_SETS, "batches": str(root / "first.pt"), "float64": True},
           {**restore, "name": "restore12", "model_axis": 2},
           {**restore, "name": "restore21", "model_axis": 1}]
    out = {}
    for world, jobs in ((4, four), (2, two)):
        spec = {"world": world, "device": "cpu", "out": str(root), "threads": 8 // (2 * world),
                "jobs": jobs}
        out.update(launch.run(spec, str(root / f"spec{world}.json"), timeout=600))
    yield root, out
    shutil.rmtree(root, ignore_errors=True)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _rel_l2(got: dict, want: dict, keys) -> float:
    g = torch.cat([got[k].double().flatten() for k in keys])
    w = torch.cat([want[k].double().flatten() for k in keys])
    return ((g - w).norm() / w.norm()).item()


def _port_cfg(sets):
    cfg = config.defaults()
    for item in sets:
        _override(cfg, item)
    return cfg


def _one_process_step(model, sets, batches, generators, restore=None):
    """The port's one-process float64 steps: (losses, last gradients by name,
    state_dict, model, optimizer)."""
    cfg = _port_cfg(sets)
    model = copy.deepcopy(model).double()
    optimizer = make_optimizer(model, cfg)
    if restore is not None:
        load_checkpoint_sharded(restore, model, optimizer)
    with launch.train_pipeline(launch.float64_pipeline(make_train_pipeline(
            False, cfg.framework.input_size))):
        step = make_train_step(model, cfg, optimizer)
    losses = [step(torch.from_numpy(b["rgb"]), torch.from_numpy(b["depth"]),
                   step_generator(*gen))["loss"].item() for b, gen in zip(batches, generators)]
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return losses, grads, model.state_dict(), model, optimizer


def test_ranks_ran_over_their_axes(ranks):
    _, out = ranks
    for name, want in (("tp22", [(0, 0), (0, 1), (1, 0), (1, 1)]), ("tp12", [(0, 0), (0, 1)]),
                       ("restore21", [(0, 0), (1, 0)])):
        assert [(r["data_index"], r["model_index"]) for r in out[name]] == want, name
        assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in out[name])


def test_megatron_layers_match_linear(ranks):
    """(1): fc1 column-, fc2 row-parallel at T = 2 against the one-process
    MLP in float64."""
    root, out = ranks
    data = torch.load(root / "mlp.pt", weights_only=True)
    mlp = Mlp(8, 32).double()
    mlp.load_state_dict(data["state_dict"])
    x = data["x"].clone().requires_grad_(True)
    y = mlp(x)
    y.backward(data["dy"])
    want = {n: p.grad for n, p in mlp.named_parameters()}
    for r in out["mlp"]:
        assert r["shapes"] == {"fc1.weight": (16, 8), "fc1.bias": (16,), "fc2.weight": (8, 16),
                               "fc2.bias": (8,)}
        np.testing.assert_allclose(r["y"].numpy(), y.detach().numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(r["dx"].numpy(), x.grad.numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(r["fc1"].numpy(), mlp.fc1(data["x"]).detach().numpy(),
                                   atol=1e-12, rtol=0)
        for k, g in want.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(), atol=1e-12, rtol=0,
                                       err_msg=k)


def _check_step(r, losses, grads, state, initial):
    """A rank job's one step against the one-process step."""
    assert all(a["losses"] == r[0]["losses"] and a["fingerprint"] == r[0]["fingerprint"]
               for a in r)
    assert _rel(r[0]["losses"][0]["loss"], losses[0]) < TOL_STEP
    assert _rel_l2(r[0]["grads"], grads, sorted(grads)) < TOL_STEP
    keys = [k for k, v in r[0]["state_dict"].items() if v.is_floating_point()]
    assert _rel_l2(r[0]["state_dict"], state, keys) < TOL_STEP
    moved = [k for k in keys if not torch.equal(state[k], initial[k].double())]
    assert len(moved) > 100
    for a in r:  # each rank holds its layout's share and no more
        assert a["param_bytes"] == a["param_bytes_predicted"]
    assert r[0]["sharded_keys"]


@pytest.mark.parametrize("name", ["tp12", "tp22"])
def test_flagship_step_equals_the_one_process_step(ranks, flagship, name):  # noqa: F811
    """(4): (1, 2) and (2, 2) against one process in float64, at the
    config's learning rate."""
    root, out = ranks
    losses, grads, state, _, _ = _one_process_step(
        flagship[3], SETS, torch.load(root / "first.pt", weights_only=False), [(0, 0, 0)])
    _check_step(out[name], losses, grads, state, flagship[3].state_dict())
    full = sum(p.numel() * 8 for p in flagship[3].parameters())
    assert all(a["param_bytes"] < full for a in out[name])


def test_da2_step_equals_the_one_process_step(ranks):
    """(5): DA-V2 vits at (1, 2) against one process in float64."""
    root, out = ranks
    model = torch.load(root / "da2.pt", weights_only=False)
    losses, grads, state, _, _ = _one_process_step(
        model, DA2_SETS, torch.load(root / "first.pt", weights_only=False), [(0, 0, 0)])
    _check_step(out["da2"], losses, grads, state, model.state_dict())


def test_tp_step_matches_jax_mesh_step(ranks, flagship):  # noqa: F811
    """(4): the (2, 2) step's loss against mde_tpu's make_mesh(2, 2) step
    with tp_param_spec's layout, at learning rate 0, on the same
    post-pipeline batch; rtol 1e-4, as the data-parallel test against
    make_mesh(2, 1)."""
    _, out = ranks
    jm, params, stats, _ = flagship
    jcfg = _cfg(jax_config)
    jcfg.framework.learning_rate = 0.0
    rgb, depth = _jax_pipeline_batch()
    jmesh = make_mesh(2, 2)
    sharded_params = shard_params_tp(params, jmesh)
    tx = jax_trainer.make_optimizer(jcfg, params)
    state = jax_trainer.TrainState(
        step=jnp.asarray(0, jnp.int32), params=sharded_params, batch_stats=replicate(stats, jmesh),
        opt_state=tx.init(sharded_params), tx=tx)
    import mde_tpu.data.transforms as jt

    saved = jt.make_train_pipeline
    jt.make_train_pipeline = lambda augmentation, size: lambda key, x, d: (x, d)
    try:
        with active_mesh(None):  # the windowed attention's XLA form, as the data-parallel test
            step = jax_trainer.make_train_step(jm, jcfg, accum_steps=1)
            batch = shard_batch({"rgb": rgb, "depth": depth}, jmesh)
            _, metrics = step(state, jax.random.key(0), batch["rgb"], batch["depth"])
    finally:
        jt.make_train_pipeline = saved
    got = out["tp22_given"]
    assert all(r["losses"] == got[0]["losses"] for r in got)
    np.testing.assert_allclose(got[0]["losses"][0]["loss"], float(metrics["loss"]), rtol=1e-4)


def test_batchnorm_reduces_over_the_data_group(ranks):
    """(6): at (1, 2) both ranks hold the batch. Over the data group the
    layer is nn.BatchNorm2d on it; over the world each row counts twice: the
    same output, and the running variance's unbiased correction of 2n rows."""
    root, out = ranks
    data = torch.load(root / "bn.pt", weights_only=True)
    bn = torch.nn.BatchNorm2d(5).double()
    bn.load_state_dict(data["state_dict"])
    x = data["x"].clone().requires_grad_(True)
    y = bn.train()(x)
    y.backward(data["dy"])
    for r in out["bn_data"]:
        np.testing.assert_allclose(r["y"].numpy(), y.detach().numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(r["dx"].numpy(), x.grad.numpy(), atol=1e-12, rtol=0)
        for k, v in bn.state_dict().items():
            np.testing.assert_allclose(r["state_dict"][k].numpy(), v.numpy(), atol=1e-12,
                                       rtol=0, err_msg=k)
    n = data["x"].numel() // data["x"].shape[1]
    var = data["x"].var(dim=(0, 2, 3), unbiased=False)
    old = data["state_dict"]["running_var"]
    for r in out["bn_world"]:
        np.testing.assert_allclose(r["y"].numpy(), y.detach().numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(r["state_dict"]["running_mean"].numpy(),
                                   bn.running_mean.numpy(), atol=1e-12, rtol=0)
        want = 0.9 * old + 0.1 * var * (2 * n) / (2 * n - 1)
        np.testing.assert_allclose(r["state_dict"]["running_var"].numpy(), want.numpy(),
                                   atol=1e-12, rtol=0)
        gap = (r["state_dict"]["running_var"] - bn.running_var).abs().max().item()
        assert gap > 1e-4, gap  # n / (n - 1) against 2n / (2n - 1), n = 84


def test_sharded_checkpoint_restores_onto_any_layout(ranks, flagship):  # noqa: F811
    """(7): the (2, 2) step's shares restored at (1, 2), (2, 1) and in one
    process are the same values, optimizer included; one more step each."""
    root, out = ranks
    losses, _, _, model, optimizer = _one_process_step(
        flagship[3], SETS, torch.load(root / "second.pt", weights_only=False), [(0, 0, 1)],
        restore=str(root / "sharded"))
    fresh = copy.deepcopy(flagship[3]).double()
    fresh_opt = make_optimizer(fresh, _port_cfg(SETS))
    assert load_checkpoint_sharded(str(root / "sharded"), fresh, fresh_opt) == {"steps": 1}
    one = fresh.state_dict()
    opt = fresh_opt.state_dict()
    saved = out["tp22"][0]["state_dict"]  # float32 copies of the (2, 2) ranks' state
    assert all(torch.equal(one[k].float() if v.is_floating_point() else one[k], v)
               for k, v in saved.items())
    assert len(opt["state"]) > 300  # AdamW's moments came back
    for name in ("restore12", "restore21"):
        r = out[name][0]
        assert all(torch.equal(r["restored"]["state_dict"][k].cpu(), v) for k, v in one.items())
        got = r["restored"]["optimizer"]["state"]
        assert sorted(got) == sorted(opt["state"])
        for i, entry in opt["state"].items():
            for k, v in entry.items():
                assert torch.equal(got[i][k].cpu(), v), (name, i, k)
        assert all(a["losses"] == r["losses"] for a in out[name])
        assert _rel(r["losses"][0]["loss"], losses[0]) < TOL_STEP, name


def test_training_cli_at_model_axis_two(tmp_path, monkeypatch):
    """(8): 5 samples at 32x64: 4 train (one step of 4), 1 val, 2 test; the
    CLI starts (data, model) = (1, 2) ranks, two threads each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    synthetic.generate(str(tmp_path / "data"), n_train=5, n_test=2, size=(30, 60), seed=1)
    argv = ["--device", "cpu", "--data-dir", str(tmp_path / "data"),
            "--set", "framework.input_size=[32, 64]", "--set", "framework.native_size=[30, 60]",
            "--set", "training.batch_size=4", "--set", "framework.num_workers=1",
            "--set", "framework.mesh.model=2", "--set", "training.n_epoch=1",
            "--set", f"paths.results_dir={tmp_path / 'results'}",
            "--set", f"paths.predictions_dir={tmp_path / 'predictions'}"]
    assert train_cli.main(argv) is None  # the ranks ran in their own processes
    results = sorted(os.listdir(tmp_path / "results"))
    ckpts = [f for f in results if f.endswith(".pth")]
    assert ckpts == ["best_model_midas_semantics_cross_attention_no_lb.pth"]
    assert len([f for f in results if f.endswith(".log.jsonl")]) == 1
    payload = load_training_checkpoint(str(tmp_path / "results" / ckpts[0]))
    one = MidasNetSemantics()
    want = {k: tuple(v.shape) for k, v in one.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in payload["model_state_dict"].items()} == want
    report = load_state_dict(one, payload["model_state_dict"])
    assert report["loaded"] == len(want) and not report["shape_mismatch"]
    # AdamW's moments by parameter, at the full shapes (dead parameters have none)
    moments = payload["optimizer_state_dict"]["state"]
    shapes = [tuple(p.shape) for p in make_optimizer(one, config.defaults()).param_groups[0]
              ["params"]]
    assert len(moments) > 300
    assert all(tuple(m["exp_avg"].shape) == shapes[int(i)] for i, m in moments.items())
    preds = sorted(os.listdir(tmp_path / "predictions"))
    assert preds == [f"test_{i:06d}_depth.npy" for i in range(2)]
    assert all(np.load(tmp_path / "predictions" / p).shape == (30, 60) for p in preds)
