"""The port's eval and metric steps, epoch loop and training CLI.

- ``make_eval_step`` and ``make_metric_step`` against JAX's at 64x96 (DINOv2
  at 28x42, B=2, weights carried by ``state_dict_from_flax``): rtol 2e-3,
  atol 2e-4, the bounds of tests/test_torch_slice.py (float32 rounding
  through ~60 layers and seven resizes).
- ``fit``'s early stopping, best checkpoint and resume seeding against JAX's
  ``fit`` with the same scripted losses: the same printed decisions.
- ``fit``'s check of a drop_last=False loader's remainder batch against
  ``grad_accum_steps``: the same ValueError as JAX's ``fit``, before any step.
- The training CLI on generated data (CPU, 60x80 images at a 64x96 input):
  the checkpoint holds the reference's training payload, predictions are
  written, and a resumed run restores the optimizer and early-stopping state.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.train import trainer as jax_trainer
from mde_tpu_torch.core import config
from mde_tpu_torch.data import synthetic
from mde_tpu_torch.tools import main as train_cli
from mde_tpu_torch.train import trainer
from mde_tpu_torch.train.checkpoint import TRAINING_KEYS, load_training_checkpoint
from tests.test_torch_slice import GEOMETRY, flagship  # noqa: F401  (module fixture)

torch.set_num_threads(2)
LOSSES = {"model": {"loss_function": {"si_loss_alpha": 1.0, "silog_loss": {"alpha": 0.3},
                                      "grad_loss_alpha": 0.2, "edge_loss_alpha": 0.1}}}


def _cfgs():
    return (config.from_dict(GEOMETRY).merge_from(LOSSES),
            jax_config.from_dict(GEOMETRY).merge_from(LOSSES))


@pytest.fixture(scope="module")
def eval_batch():
    rng = np.random.default_rng(21)
    u8 = rng.integers(0, 256, (2, 60, 80, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 8.0, (2, 60, 80)).astype(np.float32)
    return u8, depth


@pytest.mark.parametrize("which", ["eval", "metric"])
def test_eval_and_metric_steps_match_jax(flagship, eval_batch, which):  # noqa: F811
    jm, params, stats, port, _ = flagship
    cfg, jcfg = _cfgs()
    u8, depth = eval_batch
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=params, batch_stats=stats,
                                   opt_state=(), tx=None)
    make, jax_make = {"eval": (trainer.make_eval_step, jax_trainer.make_eval_step),
                      "metric": (trainer.make_metric_step, jax_trainer.make_metric_step)}[which]
    want = jax.device_get(jax_make(jm, jcfg)(state, jnp.asarray(u8), jnp.asarray(depth)))
    got = make(port, cfg)(torch.from_numpy(u8), torch.from_numpy(depth))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-3, atol=2e-4, err_msg=k)


def test_evaluate_weights_batches_and_cuts_at_n_samples(flagship, eval_batch):  # noqa: F811
    port = flagship[3]
    cfg, _ = _cfgs()
    u8, depth = eval_batch
    batches = [{"rgb": u8, "depth": depth}, {"rgb": u8[:1], "depth": depth[:1] * 2}]
    step = trainer.make_metric_step(port, cfg)
    per = [{k: v.item() for k, v in step(torch.from_numpy(b["rgb"]),
                                         torch.from_numpy(b["depth"])).items()} for b in batches]
    got = trainer.evaluate(port, cfg, batches)
    for k in got:
        np.testing.assert_allclose(got[k], (2 * per[0][k] + per[1][k]) / 3, rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(trainer.evaluate(port, cfg, batches, n_samples=1)["si_rmse"],
                               per[0]["si_rmse"], rtol=1e-6)
    suite = trainer.evaluate_full_suite(port, cfg, batches)
    assert set(suite) == {"MAE", "RMSE", "siRMSE", "REL", "Delta1", "Delta2", "Delta3"}
    assert all(np.isfinite(v) for v in suite.values()) and 0 <= suite["Delta3"] <= 1


# ---------------------------------------------------------------------------
# Early stopping against JAX's fit, with scripted losses
# ---------------------------------------------------------------------------

VAL_LOSSES = [1.0, 0.9, 0.95, 0.90005, 0.85, 0.86, 0.87, 0.88, 0.5, 0.4]
PARTS = ("si_loss", "silog_loss", "grad_loss", "edge_loss")


def _scripted(to_value):
    """Train and eval steps that return scripted losses; the val loss of
    epoch e is VAL_LOSSES[e]."""
    calls = {"eval": 0}

    def train_step(*args):
        out = {k: to_value(0.5) for k in ("loss",) + PARTS}
        return (args[0], out) if len(args) == 4 else out

    def eval_step(*args):
        calls["eval"] += 1
        v = VAL_LOSSES[calls["eval"] - 1]
        return {"loss": to_value(v), "si_loss": to_value(v),
                **{k: to_value(0.0) for k in PARTS[1:]}}

    return (lambda *a, **k: train_step), (lambda *a, **k: eval_step)


def _decisions(text):
    keep = ("Val Loss", "New best", "EarlyStopping", "Early stopping", "Best model", "Early-stopping")
    return [line for line in text.splitlines() if line.startswith(keep)]


@pytest.mark.parametrize("resume", [None, (3, 0.9, 1, 1), (2, 0.85, 1, 3)])
def test_fit_early_stopping_matches_jax(tmp_path, monkeypatch, capsys, resume):
    """patience 3, min_delta 1e-4: the same epochs run, the same checkpoints,
    the same stop, from a fresh start and from resumed states."""
    batch = {"rgb": np.zeros((2, 4, 4, 3), np.uint8), "depth": np.ones((2, 4, 4), np.float32)}
    kwargs = {}
    if resume:
        start, best_val, best_epoch, counter = resume
        kwargs = dict(start_epoch=start, best_val=best_val, best_epoch=best_epoch,
                      es_counter=counter)
    cfg, jcfg = config.defaults(), jax_config.defaults()
    for c in (cfg, jcfg):
        c.training.n_epoch = len(VAL_LOSSES)

    monkeypatch.setattr(jax_trainer, "make_train_step", _scripted(jnp.asarray)[0])
    monkeypatch.setattr(jax_trainer, "make_eval_step", _scripted(jnp.asarray)[1])
    params = {"w": jnp.zeros(2)}
    tx = optax.sgd(0.1)
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=params, batch_stats={},
                                   opt_state=tx.init(params), tx=tx)
    capsys.readouterr()
    jax_trainer.fit(None, jcfg, state, [batch] * 2, [batch], str(tmp_path / "jax"), **kwargs)
    want = _decisions(capsys.readouterr().out)

    monkeypatch.setattr(trainer, "make_train_step", _scripted(torch.tensor)[0])
    monkeypatch.setattr(trainer, "make_eval_step", _scripted(torch.tensor)[1])
    model = torch.nn.Linear(2, 2)
    history = trainer.fit(model, cfg, torch.optim.SGD(model.parameters(), lr=0.1), [batch] * 2,
                          [batch], str(tmp_path / "port"), **kwargs)
    got = _decisions(capsys.readouterr().out)
    assert got == want and any(line.startswith("Early stopping") for line in got)
    assert len(history["val_loss"]) == sum(line.startswith("Val Loss") for line in got)
    assert history["n_train"] == [4] * len(history["val_loss"])


class _Loader(list):
    """A loader of scripted batches with the host loaders' batch_size,
    num_samples and drop_last; it records whether it was iterated."""

    def __init__(self, batches, batch_size, num_samples, drop_last):
        super().__init__(batches)
        self.batch_size, self.num_samples, self.drop_last = batch_size, num_samples, drop_last
        self.iterated = False

    def __iter__(self):
        self.iterated = True
        return super().__iter__()


# 10 samples in batches of 4 leave a remainder of 2: not divisible by 4
# accumulation steps unless the loader drops it, divisible by 2.
@pytest.mark.parametrize("accum,drop_last,raises", [(4, False, True), (4, True, False),
                                                    (2, False, False)])
def test_fit_checks_the_remainder_batch_as_jax_does(tmp_path, monkeypatch, accum, drop_last,
                                                    raises):
    """Both fits refuse, before any step, a drop_last=False loader whose last
    batch is not divisible by grad_accum_steps, with the same message; a
    dropped or divisible remainder trains."""
    batch = {"rgb": np.zeros((4, 4, 4, 3), np.uint8), "depth": np.ones((4, 4, 4), np.float32)}
    cfg, jcfg = config.defaults(), jax_config.defaults()
    for c in (cfg, jcfg):
        c.training.n_epoch = 1
        c.framework.grad_accum_steps = accum

    def loader():
        return _Loader([batch] * (2 if drop_last else 3), 4, 8 if drop_last else 10, drop_last)

    built = []

    def counted(make):
        def wrapped(*args, **kwargs):
            built.append(make)
            return make(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jax_trainer, "make_train_step", counted(_scripted(jnp.asarray)[0]))
    monkeypatch.setattr(jax_trainer, "make_eval_step", _scripted(jnp.asarray)[1])
    monkeypatch.setattr(trainer, "make_train_step", counted(_scripted(torch.tensor)[0]))
    monkeypatch.setattr(trainer, "make_eval_step", _scripted(torch.tensor)[1])
    params = {"w": jnp.zeros(2)}
    tx = optax.sgd(0.1)
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=params, batch_stats={},
                                   opt_state=tx.init(params), tx=tx)
    model = torch.nn.Linear(2, 2)
    runs = {"jax": lambda train: jax_trainer.fit(None, jcfg, state, train, [batch],
                                                 str(tmp_path / "jax"))[1],
            "port": lambda train: trainer.fit(model, cfg, torch.optim.SGD(model.parameters(),
                                                                          lr=0.1),
                                              train, [batch], str(tmp_path / "port"))}
    messages = {}
    for name, run in runs.items():
        train = loader()
        if raises:
            with pytest.raises(ValueError, match="framework.drop_last") as err:
                run(train)
            messages[name] = str(err.value)
            assert not train.iterated and not built, name
        else:
            history = run(train)
            assert train.iterated and history["n_train"] == [4 * len(train)], name
    assert messages.get("jax") == messages.get("port")
    if raises:
        assert "final batch of 2 samples" in messages["port"]


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------


def _argv(root, *extra):
    return ["--device", "cpu", "--data-dir", str(root / "data"),
            "--set", "framework.input_size=[64, 96]", "--set", "framework.native_size=[60, 80]",
            "--set", "training.batch_size=2", "--set", "framework.num_workers=2",
            "--set", f"paths.results_dir={root / 'results'}",
            "--set", f"paths.predictions_dir={root / 'predictions'}",
            "--set", "experiment.wandb_disable=true", *extra]


def test_training_cli_writes_checkpoint_and_predictions_and_resumes(tmp_path, monkeypatch,
                                                                    capsys):
    synthetic.generate(str(tmp_path / "data"), n_train=8, n_test=3, size=(60, 80), seed=1)
    history = train_cli.main(_argv(tmp_path, "--set", "training.n_epoch=2"))
    assert len(history["train_loss"]) == 2
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    ckpt = tmp_path / "results" / "best_model_midas_semantics_cross_attention_no_lb.pth"
    payload = load_training_checkpoint(str(ckpt))
    assert set(payload) == set(TRAINING_KEYS)
    assert payload["config"]["early_stopping"] == {"patience": 3, "min_delta": 1e-4}
    assert payload["optimizer_state_dict"]["state"], "no optimizer moments saved"
    preds = sorted(os.listdir(tmp_path / "predictions"))
    assert preds == [f"test_{i:06d}_depth.npy" for i in range(3)]
    assert all(np.load(tmp_path / "predictions" / p).shape == (60, 80) for p in preds)

    seen = {}
    real_fit = train_cli.fit

    def spy(model, cfg, optimizer, *args, **kwargs):
        seen["optimizer"] = copy.deepcopy(optimizer.state_dict())  # fit updates it in place
        seen.update(kwargs)
        return real_fit(model, cfg, optimizer, *args, **kwargs)

    monkeypatch.setattr(train_cli, "fit", spy)
    capsys.readouterr()
    history = train_cli.main(_argv(tmp_path, "--set", "training.n_epoch=3",
                                   "--set", "training.resume_training.resume=true",
                                   "--set", "training.resume_training.resume_from_epoch=2"))
    assert "Resumed early-stopping state" in capsys.readouterr().out
    assert len(history["train_loss"]) == 1  # epochs 2..3
    assert seen["start_epoch"] == 2
    assert (seen["best_val"], seen["best_epoch"], seen["es_counter"]) == (
        payload["best_val_loss"], payload["best_epoch"], payload["early_stopping_counter"])
    saved, restored = payload["optimizer_state_dict"]["state"], seen["optimizer"]["state"]
    assert saved.keys() == restored.keys()
    for i in saved:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(saved[i][k], restored[i][k]), (i, k)


def test_training_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_cli.main(["--device", "cuda", "--data-dir", str(tmp_path)])
