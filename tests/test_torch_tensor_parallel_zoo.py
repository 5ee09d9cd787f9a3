"""Tensor parallelism for the BEiT, Swin V1, Swin V2 and Next-ViT trunks
(``parallel/mesh.py::tp_layout``, ``parallel/tensor.py::tensor_parallel``)
against one process and against the JAX package's (data, model) mesh, on
the CPU over gloo.

BEiT and Swin are narrowed in both packages (``monkeypatch.setitem`` on
``BEIT_CONFIGS`` and ``SWIN_CONFIGS``, as tests/test_torch_dpt_trunks.py
does) at their depths and hooks: BEiT-B 32 wide with 4 heads on a 4x6 token
grid (not its 3x3 pretraining grid, so each rank resizes its share of the
bias table), Swin V1 (``swinl12_384``) and V2 (``swin2t16_256``) 16 wide
with heads (1, 2, 4, 4) and window 4 on 64x128 inputs: the first stage's
single head does not divide T = 2, the first two stages' heads not T = 4,
and those attentions stay whole, tables and all. Next-ViT-L runs at full
width on 64x64 (its stage-2 NTB's 6 heads stay whole at T = 4). Weights
come from the JAX init drawn from a seed (``test_torch_dpt_trunks.
_jax_weights``: bias tables, logit scales, BN statistics and LayerScale
gammas not alike) through ``state_dict_from_flax``.

Without processes (and the factory's loader rows, which the training CLI
and the server build from ``model.model_type``):
  (1) for each family at T = 2 and 4, ``gather_state_dict`` of the ranks'
      ``shard_state_dict`` shares is the state_dict bit for bit, each
      sharded tensor's share is 1/T of it, and each per-head share holds
      its rank's heads: a fused ``qkv`` heads [r H / T, (r + 1) H / T) of
      each of q, k and v, a bias table those columns, ``q_bias``,
      ``v_bias``, ``logit_scale`` and ``cpb_mlp.2`` those rows; and
      ``tensor_parallel`` at each rank of T gives the model that share
      under the same names, its sharded Linears the Megatron layers;
  (2) the port's sharded keys at T = 2 equal the leaves
      ``mde_tpu.parallel.tp_param_spec`` shards on the same model's JAX
      tree, carried into the port's grammar by ``state_dict_from_flax``,
      apart from the layout's two stated rules: an attention whose heads
      do not divide T stays whole (``tp_param_spec`` splits its kernels
      between heads), and the per-head tables (BEiT's and Swin V1's bias
      tables, V2's logit scales and ``cpb_mlp.2``) are sharded with their
      heads where GSPMD keeps them whole.

Over gloo (``mde_tpu_torch.parallel.launch``), two starts: four ranks, then
two:
  (3) one float64 step of each family's DPT at (1, 2) against the port's
      one-process step on the same global batch of 2 and generator, at the
      config's learning rate: loss at rel 1e-5, the gathered gradient and
      state at rel-L2 1e-5, and the gradient of each ``norm1`` (the input
      side of the attention: it is whole only when the column layer's
      input collective ran), of Next-ViT's ``proj1_bn`` (the same before
      its E-MHSA) and of V2's ``cpb_mlp.0`` (replicated, fed by the
      column-parallel ``cpb_mlp.2``) at rel-L2 1e-5 on its own; the
      same values on every rank, each rank's parameter bytes at the
      layout's share;
  (4) the (2, 2) step of the BEiT-B and Swin V2 DPTs on the JAX train
      pipeline's outputs, float32 at learning rate 0, against mde_tpu's
      ``make_train_step`` over ``make_mesh(2, 2)`` with
      ``shard_params_tp``'s layout: loss at rtol 1e-4, the tolerance of
      ``test_torch_tensor_parallel::test_tp_step_matches_jax_mesh_step``;
  (5) the Swin V2 (2, 2) step's sharded checkpoint restored at (1, 2) and
      in one process: identical parameters, buffers and AdamW moments,
      then one step each, its loss at rel 1e-5 across the two.
"""

import copy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.data import transforms as JT
from mde_tpu.models.dpt import DPTDepthModel as JDPT
from mde_tpu.nn import beit as jbeit
from mde_tpu.nn import swin as jswin
from mde_tpu.parallel import (active_mesh, make_mesh, replicate, shard_batch, shard_params_tp,
                              tp_param_spec)
from mde_tpu.train import trainer as jax_trainer
from mde_tpu_torch.core import config
from mde_tpu_torch.data.transforms import make_train_pipeline
from mde_tpu_torch.models import factory
from mde_tpu_torch.models.dpt import DPTDepthModel
from mde_tpu_torch.models.model_loader import DEFAULT_MODELS
from mde_tpu_torch.nn import beit, swin
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.parallel import distributed, launch
from mde_tpu_torch.parallel.mesh import mesh_world, tp_layout
from mde_tpu_torch.parallel.tensor import (ColumnParallelLinear, RowParallelLinear,
                                           gather_state_dict, shard_state_dict, tensor_parallel)
from mde_tpu_torch.tools.common import _override, bootstrap_model, parse_config
from mde_tpu_torch.train.checkpoint import load_checkpoint_sharded, load_state_dict
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import make_optimizer, make_train_step, step_generator
from tests.test_torch_dpt_trunks import _jax_weights

torch.set_num_threads(2)

TOL_STEP = 1e-5
# (dim, depth, heads, patch, pretrain grid): 64x96 inputs give a 4x6 grid
NARROW_BEIT = {"beitb16_384": (32, 12, 4, 16, (3, 3))}
# (version, embed, depths, heads, window)
NARROW_SWIN = {"swinl12_384": (1, 16, (2, 2, 2, 2), (1, 2, 4, 4), 4),
               "swin2t16_256": (2, 16, (2, 2, 2, 2), (1, 2, 4, 4), 4)}
# family: (loader row, input (h, w))
FAMILIES = {"beit": ("dpt_beit_base_384", (64, 96)), "swin": ("dpt_swin_large_384", (64, 128)),
            "swin2": ("dpt_swin2_tiny_256", (64, 128)),
            "next_vit": ("dpt_next_vit_large_384", (64, 64))}
# the replicated layers whose gradient reaches them through a column
# layer's input collective alone: BEiT's and Swin's pre-attention norm (V2's
# post-norm sits on the attention's input too: its residual), V2's first
# position-bias layer, Next-ViT's BN before the E-MHSA
INNER = ("norm1", "cpb_mlp.0", "proj1_bn")
# what GSPMD keeps whole and the port shards with the heads
TABLES = ("relative_position_bias_table", "logit_scale", "cpb_mlp.2.weight")


@pytest.fixture(autouse=True)
def narrow(monkeypatch):
    for table in (jbeit.BEIT_CONFIGS, beit.BEIT_CONFIGS):
        for k, v in NARROW_BEIT.items():
            monkeypatch.setitem(table, k, v)
    for table in (jswin.SWIN_CONFIGS, swin.SWIN_CONFIGS):
        for k, v in NARROW_SWIN.items():
            monkeypatch.setitem(table, k, v)


def _backbone(family):
    return DEFAULT_MODELS[FAMILIES[family][0]][0]["backbone"]


_BUILT = {}


def built(family):
    """(JAX module, params, stats, port with the JAX weights) of a family's
    narrowed DPT, once. The final depth bias is raised by 0.5, so the last
    ReLU passes most of the map."""
    if family not in _BUILT:
        size = FAMILIES[family][1]
        jm = JDPT(backbone=_backbone(family))
        params, stats = _jax_weights(jm, size, np.random.default_rng(0))
        params["head_conv4"]["Conv_0"]["bias"] += 0.5
        port = init_weights_(DPTDepthModel(_backbone(family), input_size=size),
                             torch.Generator().manual_seed(0))
        report = load_state_dict(port, state_dict_from_flax(params, stats, "DPTDepthModel"))
        assert not report["unexpected"] and not report["shape_mismatch"], report
        _BUILT[family] = jm, params, stats, port
    return _BUILT[family]


def _heads_of(model):
    """{attention prefix: head count} of every module with ``num_heads``."""
    return {n: m.num_heads for n, m in model.named_modules() if hasattr(m, "num_heads")}


def _owner(key, heads):
    return max((p for p in heads if key.startswith(p + ".")), key=len, default=None)


# ---------------------------------------------------------------------------
# (1), (2): the layout, without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gather_inverts_shard_and_shares_hold_their_heads(family, size):
    model = built(family)[3]
    sd = model.state_dict()
    layout = tp_layout(model, size)
    shares = [shard_state_dict(sd, layout, size, r) for r in range(size)]
    back = gather_state_dict(shares, layout)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    heads = _heads_of(model)
    sharded = [k for k, v in layout.items() if v != "replicated"]
    assert any(_owner(k, heads) for k in sharded)  # some attention is sharded
    whole = [p for p, h in heads.items() if h % size]  # stays whole, tables and all
    assert bool(whole) == (family in ("swin", "swin2") or (family, size) == ("next_vit", 4))
    assert not any(_owner(k, heads) in whole for k in sharded)
    for k in sharded:
        assert all(s[k].numel() * size == sd[k].numel() for s in shares), k
        owner = _owner(k, heads)
        if owner is None or k.endswith(("proj.weight", "proj.bias")):
            continue
        h = heads[owner]
        per = h // size
        full = sd[k]
        for r, s in enumerate(shares):
            if k.endswith("qkv.weight") or k.endswith("qkv.bias"):
                want = full.reshape(3, h, -1)[:, r * per:(r + 1) * per].reshape(s[k].shape)
            elif k.endswith("relative_position_bias_table"):
                want = full[:, r * per:(r + 1) * per]
            else:  # q/k/v, q_bias, v_bias, logit_scale, cpb_mlp.2: the heads on dim 0
                want = full.reshape(h, -1)[r * per:(r + 1) * per].reshape(s[k].shape)
            assert torch.equal(s[k], want), (k, r)
    kinds = {layout[k] for k in sharded if k.endswith(TABLES)}
    assert kinds <= {"heads", "column"}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tensor_parallel_gives_each_rank_its_share(family, size, monkeypatch):
    """``tensor_parallel`` at rank r of T (the model axis stood in for by
    ``distributed.model_count`` / ``model_index``): the state_dict is
    ``shard_state_dict``'s share under the same names, the sharded Linears
    are the Megatron layers, and the rest is untouched."""
    model = built(family)[3]
    sd = model.state_dict()
    layout = tp_layout(model, size)
    monkeypatch.setattr(distributed, "model_count", lambda: size)
    for rank in range(size):
        monkeypatch.setattr(distributed, "model_index", lambda: rank)
        share = tensor_parallel(copy.deepcopy(model), size)
        assert share.tp_share == (size, rank, layout)
        want = shard_state_dict(sd, layout, size, rank)
        got = share.state_dict()
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        modules = dict(share.named_modules())
        for key, kind in layout.items():
            path = key.rsplit(".", 1)[0]
            if kind in ("column", "row") and key.endswith(".weight") and path in modules:
                assert type(modules[path]) is (ColumnParallelLinear if kind == "column"
                                               else RowParallelLinear), key


def _jax_sharded_keys(family, size):
    """The port keys of the leaves tp_param_spec shards, through
    state_dict_from_flax: sharded leaves as ones, the rest as zeros."""
    jm = JDPT(backbone=_backbone(family))
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, *FAMILIES[family][1], 3))),
                            jax.random.key(0))

    def mark(tree, path=()):
        if hasattr(tree, "items"):
            return {k: mark(v, path + (k,)) for k, v in tree.items()}
        spec = tp_param_spec(path, tree.shape, size)
        return np.full(tree.shape, float(any(a is not None for a in spec)), np.float32)

    sd = state_dict_from_flax(mark(shapes["params"]),
                              mark(shapes.get("batch_stats", {}), ("stats",)), "DPTDepthModel")
    ones = {k for k, v in sd.items() if v.numel() and bool((v == 1).all())}
    mixed = [k for k, v in sd.items() if v.numel() and 0 < float(v.sum()) < v.numel()]
    assert not mixed, mixed
    return ones


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_keys_equal_tp_param_spec_but_for_the_stated_rules(family):
    with torch.device("meta"):
        model = DPTDepthModel(_backbone(family), input_size=FAMILIES[family][1])
    layout = tp_layout(model, 2)
    ours = {k for k, v in layout.items() if v != "replicated"}
    jax_keys = _jax_sharded_keys(family, 2)
    heads = _heads_of(model)
    whole = {p for p, h in heads.items() if h % 2}
    # rule 1: tp_param_spec splits these attentions between heads, the port keeps them whole
    split_heads = {k for k in jax_keys - ours if _owner(k, heads) in whole}
    # rule 2: the per-head tables, whole under GSPMD, sharded with their heads here
    tables = {k for k in ours - jax_keys if k.endswith(TABLES)}
    assert ours == (jax_keys - split_heads) | tables
    assert bool(split_heads) == (family in ("swin", "swin2"))  # stage 1's single head
    assert bool(tables) == (family != "next_vit")
    assert not any(_owner(k, heads) in whole for k in ours)


def test_model_axis_takes_every_family():
    """``mesh_world`` gives (1, T) for each loader DPT on the CPU."""
    cfg = config.defaults()
    cfg.framework.mesh.model = 2
    for row in (r for r, _ in FAMILIES.values()):
        cfg.model.model_type = row
        assert mesh_world(cfg, "cpu") == (1, 2), row


@pytest.mark.parametrize("row", sorted(DEFAULT_MODELS))
def test_factory_builds_the_loader_dpt_rows(row):
    """``model.model_type`` names any DPT row of the loader (the training CLI
    and the server build it through the factory) at the row's input size;
    the loader's other rows stay unknown to the factory, as in mde_tpu."""
    cfg = config.defaults()
    cfg.model.model_type = row
    spec, size, _ = DEFAULT_MODELS[row]
    if isinstance(spec, dict):
        assert factory._model_class(cfg.model) == (DPTDepthModel, {**spec, "input_size": size})
    else:
        with pytest.raises(ValueError, match="Unknown model_type"):
            factory._model_class(cfg.model)


@pytest.mark.parametrize("row", ["dpt_beit_base_384", "dpt_swin2_tiny_256"])
def test_config_takes_the_loader_rows_input_size(row):
    """One ``--set model.model_type=<row>`` makes ``framework.input_size``
    the row's, in a tool's config and in a rank's job; a ``--set`` of
    another size stays, and ``bootstrap_model`` refuses that config."""
    size = list(DEFAULT_MODELS[row][1])
    argv = ["--device", "cpu", "--set", f"model.model_type={row}"]
    cfg, _ = parse_config("test", argv=argv)
    assert list(cfg.framework.input_size) == size
    job = launch._config({"sets": [f"model.model_type={row}"]})
    assert list(job.framework.input_size) == size
    cfg, _ = parse_config("test", argv=argv + ["--set", "framework.input_size=[64,64]"])
    assert list(cfg.framework.input_size) == [64, 64]
    with pytest.raises(ValueError, match="is built for"):
        bootstrap_model(cfg, "cpu")


def test_layout_shards_only_what_a_module_declares():
    """A Linear is sharded only where its module names it in
    ``tp_linears``: the same names undeclared stay replicated, and a
    declared part that is not an ``nn.Linear`` raises."""
    block = torch.nn.Module()
    block.qkv, block.proj, block.norm = (torch.nn.Linear(8, 24), torch.nn.Linear(8, 8),
                                         torch.nn.LayerNorm(8))
    assert set(tp_layout(block, 2).values()) == {"replicated"}
    block.tp_linears = {"qkv": "column", "proj": "row"}
    assert {k: v for k, v in tp_layout(block, 2).items() if v != "replicated"} == {
        "qkv.weight": "column", "qkv.bias": "column", "proj.weight": "row"}
    block.tp_linears = {"norm": "column"}
    with pytest.raises(ValueError, match="shards an nn.Linear"):
        tp_layout(block, 2)


# ---------------------------------------------------------------------------
# Gloo ranks
# ---------------------------------------------------------------------------

LOSS_SETS = ["framework.compute_dtype=float32", "model.loss_function.si_loss_alpha=1.0",
             "model.loss_function.silog_loss.alpha=0.3",
             "model.loss_function.silog_loss.variance_focus=0.85",
             "model.loss_function.grad_loss_alpha=0.2", "model.loss_function.edge_loss_alpha=0.1"]


def _sets(family, *extra):
    h, w = FAMILIES[family][1]
    return LOSS_SETS + [f"framework.input_size=[{h},{w}]", f"framework.native_size=[{h},{w}]",
                        *extra]


def _jax_cfg(family):
    """mde_tpu's config with ``_sets(family)``'s values, at learning rate 0."""
    cfg = jax_config.defaults()
    cfg.framework.input_size = cfg.framework.native_size = list(FAMILIES[family][1])
    cfg.framework.compute_dtype = "float32"
    cfg.framework.learning_rate = 0.0
    lf = cfg.model.loss_function
    lf.si_loss_alpha, lf.silog_loss.alpha, lf.silog_loss.variance_focus = 1.0, 0.3, 0.85
    lf.grad_loss_alpha, lf.edge_loss_alpha = 0.2, 0.1
    return cfg


def _global_batch(seed, rows=2, shape=(60, 80)):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 256, (rows, *shape, 3), dtype=np.uint8),
            "depth": rng.uniform(0.5, 5.0, (rows, *shape)).astype(np.float32)}


def _jax_pipeline_batch(family):
    """One post-pipeline global batch from JAX's train pipeline (NHWC)."""
    b = _global_batch(31)
    rgb, depth = JT.make_train_pipeline(False, FAMILIES[family][1])(
        jax.random.key(100), jnp.asarray(b["rgb"]), jnp.asarray(b["depth"]))
    return np.asarray(rgb), np.asarray(depth)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of (3)-(5): four gloo ranks, then two."""
    root = tmp_path_factory.mktemp("tensor_parallel_zoo")
    with pytest.MonkeyPatch.context() as m:  # the module fixture builds narrowed models
        for table in (jbeit.BEIT_CONFIGS, beit.BEIT_CONFIGS):
            for k, v in NARROW_BEIT.items():
                m.setitem(table, k, v)
        for table in (jswin.SWIN_CONFIGS, swin.SWIN_CONFIGS):
            for k, v in NARROW_SWIN.items():
                m.setitem(table, k, v)
        for family in FAMILIES:
            torch.save(built(family)[3], root / f"{family}.pt")
            if family in ("beit", "swin2"):
                rgb, depth = _jax_pipeline_batch(family)
                torch.save([{"rgb": rgb.transpose(0, 3, 1, 2).copy(), "depth": depth}],
                           root / f"given_{family}.pt")
    torch.save([_global_batch(7)], root / "first.pt")
    step = {"mode": "steps", "generators": [[0, 0, 0]], "grads": True}
    four = [{**step, "name": f"{f}22_given", "model": str(root / f"{f}.pt"), "model_axis": 2,
             "batches": str(root / f"given_{f}.pt"), "given": True,
             "sets": _sets(f, "framework.learning_rate=0")} for f in ("beit", "swin2")]
    four[1]["save_sharded"] = str(root / "sharded")
    two = [{**step, "name": f"{f}12", "model": str(root / f"{f}.pt"), "model_axis": 2,
            "batches": str(root / "first.pt"), "float64": True, "sets": _sets(f)}
           for f in sorted(FAMILIES)]
    two.append({**four[1], "name": "restore12", "restore": str(root / "sharded"),
                "generators": [[0, 0, 1]]})
    del two[-1]["save_sharded"]
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


def _one_process_step(model, sets, batches, generators, float64=True, given=False,
                      restore=None):
    """The port's one-process steps: (losses, last gradients by name,
    state_dict, model, optimizer)."""
    cfg = _port_cfg(sets)
    model = copy.deepcopy(model)
    pipeline = (launch.given_pipeline if given
                else make_train_pipeline(False, cfg.framework.input_size))
    if float64:
        model, pipeline = model.double(), launch.float64_pipeline(pipeline)
    optimizer = make_optimizer(model, cfg)
    if restore is not None:
        load_checkpoint_sharded(restore, model, optimizer)
    with launch.train_pipeline(pipeline):
        step = make_train_step(model, cfg, optimizer)
    losses = [step(torch.as_tensor(b["rgb"]), torch.as_tensor(b["depth"]),
                   step_generator(*gen))["loss"].item() for b, gen in zip(batches, generators)]
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return losses, grads, model.state_dict(), model, optimizer


def test_ranks_ran_over_their_axes(ranks):
    _, out = ranks
    for name, want in (("beit22_given", [(0, 0), (0, 1), (1, 0), (1, 1)]),
                       ("swin212", [(0, 0), (0, 1)])):
        assert [(r["data_index"], r["model_index"]) for r in out[name]] == want, name
        assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in out[name])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_step_equals_the_one_process_step(ranks, family):
    """(3): (1, 2) against one process in float64, at the config's learning
    rate; the attention's input side (``INNER``) on its own."""
    root, out = ranks
    model = built(family)[3]
    losses, grads, state, _, _ = _one_process_step(
        model, _sets(family), torch.load(root / "first.pt", weights_only=False), [(0, 0, 0)])
    r = out[f"{family}12"]
    assert all(a["losses"] == r[0]["losses"] and a["fingerprint"] == r[0]["fingerprint"]
               for a in r)
    assert _rel(r[0]["losses"][0]["loss"], losses[0]) < TOL_STEP
    got = r[0]["grads"]
    assert sorted(got) == sorted(grads)
    assert _rel_l2(got, grads, sorted(grads)) < TOL_STEP
    inner = [k for k in grads if k.rsplit(".", 2)[-2] in INNER]
    assert len(inner) >= 16
    for k in inner:
        assert _rel_l2(got, grads, [k]) < TOL_STEP, k
    keys = [k for k, v in r[0]["state_dict"].items() if v.is_floating_point()]
    assert _rel_l2(r[0]["state_dict"], state, keys) < TOL_STEP
    moved = [k for k in keys if not torch.equal(state[k], model.state_dict()[k].double())]
    assert len(moved) > 50
    for a in r:  # each rank holds its layout's share and no more
        assert a["param_bytes"] == a["param_bytes_predicted"] < a["param_bytes_whole"]
    sharded = r[0]["sharded_keys"]
    assert any(".attn." in k or ".emhsa." in k for k in sharded)
    if family != "next_vit":
        assert any(k.endswith(TABLES) for k in sharded)


@pytest.mark.parametrize("family", ["beit", "swin2"])
def test_tp_step_matches_jax_mesh_step(ranks, family):
    """(4): the (2, 2) step's loss against mde_tpu's make_mesh(2, 2) step
    with tp_param_spec's layout, at learning rate 0, on the same
    post-pipeline batch; rtol 1e-4."""
    _, out = ranks
    jm, params, stats, _ = built(family)
    jcfg = _jax_cfg(family)
    rgb, depth = _jax_pipeline_batch(family)
    jmesh = make_mesh(2, 2)
    sharded_params = shard_params_tp(params, jmesh)
    tx = jax_trainer.make_optimizer(jcfg, params)
    state = jax_trainer.TrainState(
        step=jnp.asarray(0, jnp.int32), params=sharded_params, batch_stats=replicate(stats, jmesh),
        opt_state=tx.init(sharded_params), tx=tx)
    saved = JT.make_train_pipeline
    JT.make_train_pipeline = lambda augmentation, size: lambda key, x, d: (x, d)
    try:
        with active_mesh(None):
            step = jax_trainer.make_train_step(jm, jcfg, accum_steps=1)
            batch = shard_batch({"rgb": rgb, "depth": depth}, jmesh)
            _, metrics = step(state, jax.random.key(0), batch["rgb"], batch["depth"])
    finally:
        JT.make_train_pipeline = saved
    got = out[f"{family}22_given"]
    assert all(r["losses"] == got[0]["losses"] for r in got)
    assert all(a["param_bytes"] == a["param_bytes_predicted"] for a in got)
    np.testing.assert_allclose(got[0]["losses"][0]["loss"], float(metrics["loss"]), rtol=1e-4)


def test_sharded_checkpoint_restores_at_one_two_and_in_one_process(ranks):
    """(5): the Swin V2 (2, 2) step's shares restored at (1, 2) and in one
    process are the same values, AdamW's moments included; one more step
    each, its loss at rel 1e-5 across the two."""
    root, out = ranks
    model = built("swin2")[3]
    sets = _sets("swin2", "framework.learning_rate=0")
    batches = torch.load(root / "given_swin2.pt", weights_only=False)
    losses, _, _, _, _ = _one_process_step(model, sets, batches, [(0, 0, 1)], float64=False,
                                           given=True, restore=str(root / "sharded"))
    fresh = copy.deepcopy(model)
    fresh_opt = make_optimizer(fresh, _port_cfg(sets))
    assert load_checkpoint_sharded(str(root / "sharded"), fresh, fresh_opt) == {"steps": 1}
    one = fresh.state_dict()
    opt = fresh_opt.state_dict()
    saved = out["swin222_given"][0]["state_dict"]  # the (2, 2) ranks' state, gathered
    assert all(torch.equal(one[k], v) for k, v in saved.items())
    assert len(opt["state"]) > 100  # AdamW's moments came back
    r = out["restore12"][0]
    assert all(torch.equal(r["restored"]["state_dict"][k], v) for k, v in one.items())
    got = r["restored"]["optimizer"]["state"]
    assert sorted(got) == sorted(opt["state"])
    for i, entry in opt["state"].items():
        for k, v in entry.items():
            assert torch.equal(got[i][k], v), (i, k)
    assert all(a["losses"] == r["losses"] for a in out["restore12"])
    assert _rel(r["losses"][0]["loss"], losses[0]) < TOL_STEP
