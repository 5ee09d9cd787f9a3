"""The serving archive (train/export.py) of the model factory's models on the
CPU, each as tests/test_torch_zoo_models.py builds it: 64x96 input, the JAX
weights carried over, BN statistics randomised, the final depth bias raised
by 0.5. Each is exported once, at buckets (1, 2) and native 60x80. This file
takes the flagship with LocalBins (and its dead DGR blocks), MiDaS-small
with LocalBins and DGR, and U-Net; tests/test_torch_export_zoo_more.py the
other four (MiDaS-small, MidasNet, DPT_Large, DPT_Hybrid), so that each file
stays within about 150 s on one worker (the JAX builds take most of it).

For each model (tests/torch_export_checks.py holds the checks and bounds):
(a) the exported predictor against the port's live predict step, rtol 0 and
    atol 1e-6;
(b) against mde_tpu's predict step on the same weights, at the bound of the
    model's forward test against JAX (rtol 1e-4, atol ``_atol``: 1e-5, and
    DPT_Hybrid's 5e-5 of the map's largest value; corrcoef > 0.9999);
(c) each bucket's graph: K3's op once, K1's once on the flagship, K4's once a
    ViT block (12 on the flagship's DINOv2 and DPT_Hybrid, 24 on DPT_Large),
    and no plain version's operation beyond LocalBins' own softmax;
(d) ``weights.pt`` holds every tensor with its dtype and bits (LocalBins'
    int64 ``k_idx`` and ``K_minus_1``, DGR's Laplacian taps), each program
    takes every key, and a second predictor gives the same bits;
(f) ``warmup()`` runs every bucket once.
Then (g) the export CLI on a LocalBins + DGR MiDaS-small checkpoint through
its ``--set``s.
"""
import numpy as np
import pytest
import torch

from mde_tpu_torch.tools import common, export_model
from mde_tpu_torch.train import export as E
from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
from mde_tpu_torch.train.trainer import make_predict_step
from tests import torch_export_checks as X
from tests.test_torch_zoo_models import SIZE, _atol, built

torch.set_num_threads(2)

NAMES = ["flagship_lb", "midas_small_lb_dgr", "unet"]
LB_DGR = {"k_idx": torch.int64, "K_minus_1": torch.float32, "lap2.weight": torch.float32,
          "lap3.weight": torch.float32}
WANT_OPS = {
    "midas_small": {"preprocess_u8": 1},
    "midas_small_lb_dgr": {"preprocess_u8": 1},
    "flagship_lb": {"preprocess_u8": 1, "window_attention": 1, "flash_attention": 12},
    "unet": {"preprocess_u8": 1},
    "midas": {"preprocess_u8": 1},
    "dpt_large": {"preprocess_u8": 1, "flash_attention": 24},
    "dpt_hybrid": {"preprocess_u8": 1, "flash_attention": 12},
}
OWN_SOFTMAX = {"midas_small_lb_dgr": 1, "flagship_lb": 1}  # LocalBins' LogBinomial
BUFFERS = {"midas_small_lb_dgr": LB_DGR, "flagship_lb": LB_DGR}


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """name -> X.Archive, exported on first use."""
    root, cache = tmp_path_factory.mktemp("export_zoo"), {}

    def get(name):
        if name not in cache:
            cache[name] = X.Archive(built(name)[3], SIZE, root / f"{name}.mdex")
        return cache[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_exported_matches_live_step(archives, name):
    X.check_live(archives(name))


@pytest.mark.parametrize("name", NAMES)
def test_exported_matches_jax(archives, name):
    jm, params, stats, *_ = built(name)
    X.check_jax(archives(name), jm, params, stats, 1e-4, lambda w: _atol(name, w))


@pytest.mark.parametrize("name", NAMES)
def test_graphs_hold_the_kernel_ops(archives, name):
    X.check_graphs(archives(name), WANT_OPS[name], OWN_SOFTMAX.get(name, 0))


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip(archives, name):
    X.check_weights(archives(name), BUFFERS.get(name, {}))


def test_warmup_runs_every_bucket(archives):
    X.check_warmup(archives("midas_small_lb_dgr"))


def test_export_cli_on_a_localbins_dgr_checkpoint(tmp_path, monkeypatch, capsys):
    """The CLI with the model's ``--set``s builds MiDaS-small with LocalBins
    and DGR, refuses without a checkpoint, then exports the checkpoint's
    weights; the archive equals the live step on the checkpoint's model."""
    port = built("midas_small_lb_dgr")[3]
    sets = ["model.dinov2_type=null", "model.network.use_lb=true", "model.network.use_dgr=true",
            f"paths.results_dir={tmp_path}", f"framework.input_size=[{SIZE[0]},{SIZE[1]}]",
            f"framework.native_size=[{X.NATIVE[0]},{X.NATIVE[1]}]"]
    out = tmp_path / "lb_dgr.mdex"
    argv = ["--device", "cpu", "--out", str(out), "--max-batch", "2"]
    argv += [a for s in sets for a in ("--set", s)]
    with pytest.raises(FileNotFoundError, match="refusing to export"):
        export_model.main(argv)
    cfg, _ = common.parse_config("test", argv=[a for s in sets for a in ("--set", s)])
    save_checkpoint(checkpoint_path(str(tmp_path), cfg.experiment.model_name), port)
    built_models = []
    build = common.build_model
    monkeypatch.setattr(common, "build_model",
                        lambda *a, **k: built_models.append(build(*a, **k)) or built_models[-1])
    meta = export_model.main(argv)
    assert f"Wrote {out}" in capsys.readouterr().out
    model = built_models[0]
    assert model.use_lb and model.use_dgr and type(model) is type(port)
    assert meta["batch_sizes"] == list(X.BUCKETS) and meta["model_type"] == "MiDaS_small"
    predictor = E.load_exported(str(out), "cpu")
    for b in X.BUCKETS:
        u8 = X.batch(20 + b, b)
        np.testing.assert_allclose(predictor.predict(u8),
                                   make_predict_step(port, cfg)(torch.from_numpy(u8)).numpy(),
                                   rtol=0, atol=1e-6)
