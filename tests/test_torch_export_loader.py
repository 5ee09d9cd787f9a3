"""The serving archive (train/export.py) of the MiDaS v3.1 loader's DPTs on the
CPU, one of each trunk family: BEiT-B/384, Swin2-T/256, Swin-L/384 (V1),
LeViT/224 and Next-ViT-L/384, each as tests/test_torch_dpt_trunks.py builds
it under its narrowing fixture (BEiT and Swin narrowed in both packages;
BEiT at 64x96, Swin at 64x128, LeViT at 128x128, Next-ViT at 64x64), the JAX
weights carried over, the final depth bias raised by 0.5. Each is exported
once, at buckets (1, 2) and native 60x80; the predict step resizes each map
to the native size with align corners (LeViT's is 6 pixels short).

For each model (tests/torch_export_checks.py holds the checks and bounds):
(a) the exported predictor against the port's live predict step, rtol 0 and
    atol 1e-6;
(b) against mde_tpu's predict step on the same weights, at the trunk file's
    bound for the DPTs against JAX (rtol 1e-4, atol 1e-5, corrcoef > 0.9999);
(c) each bucket's graph: K3's op once and no other kernel op (the trunks'
    attention is ``nn/blocks.py::biased_attention``, plain PyTorch in mde_tpu
    too), and no plain version's operation beyond the trunk's own softmaxes,
    one an attention;
(d) ``weights.pt`` holds every tensor with its dtype and bits (BEiT's int64
    ``relative_position_index``, LeViT's int64 ``attention_bias_idxs``),
    each program takes every key, and a second predictor gives the same bits;
(e) ``nn/blocks.py::device_constant`` (Swin's and BEiT's indices, offsets and
    masks, made inside the forward): in fresh interpreters, export first and
    then the live step, and the live step first and then export, each giving
    the same bits, with every kept constant a real tensor and the program
    holding the indices as constants;
(f) ``warmup()`` runs every bucket once.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from tests import torch_export_checks as X
from tests.test_torch_dpt_trunks import NARROW_SWIN, built, narrow  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NAMES = ["dpt_beit_base_384", "dpt_swin2_tiny_256", "dpt_swin_large_384", "dpt_levit_224",
         "dpt_next_vit_large_384"]
# each trunk's own softmaxes: one an attention (narrowed BEiT-B: 12 blocks;
# the narrowed Swins: 8; LeViT: 8 blocks and 3 subsampling attentions;
# Next-ViT-L: 8 E-MHSA blocks at 64x64)
OWN_SOFTMAX = {"dpt_beit_base_384": 12, "dpt_swin2_tiny_256": 8, "dpt_swin_large_384": 8,
               "dpt_levit_224": 11, "dpt_next_vit_large_384": 8}
BUFFERS = {"dpt_beit_base_384": {"relative_position_index": torch.int64},
           "dpt_levit_224": {"attention_bias_idxs": torch.int64}}


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """name -> X.Archive, exported on first use."""
    root, cache = tmp_path_factory.mktemp("export_loader"), {}

    def get(name):
        if name not in cache:
            *_, port, _, size = built(name)
            cache[name] = X.Archive(port, size, root / f"{name}.mdex")
        return cache[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_exported_matches_live_step(archives, name):
    X.check_live(archives(name))


@pytest.mark.parametrize("name", NAMES)
def test_exported_matches_jax(archives, name):
    jm, params, stats, *_ = built(name)
    X.check_jax(archives(name), jm, params, stats, 1e-4, lambda w: 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_graphs_hold_the_kernel_ops(archives, name):
    X.check_graphs(archives(name), {"preprocess_u8": 1}, OWN_SOFTMAX[name])


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip(archives, name):
    X.check_weights(archives(name), BUFFERS.get(name, {}))


def test_warmup_runs_every_bucket(archives):
    X.check_warmup(archives("dpt_levit_224"))


# A fresh interpreter: the narrowed Swin2-T DPT from seed 0 (depth bias +0.5),
# exported at bucket 1 and run live, in the order argv[1] names.
ORDER_CHILD = textwrap.dedent('''
    import io, json, sys
    import numpy as np, torch
    torch.set_num_threads({threads})
    from mde_tpu_torch.core import config
    from mde_tpu_torch.models.dpt import DPTDepthModel
    from mde_tpu_torch.nn import blocks, swin
    from mde_tpu_torch.nn.blocks import init_weights_
    from mde_tpu_torch.train import export as E
    from mde_tpu_torch.train.trainer import make_predict_step
    swin.SWIN_CONFIGS["swin2t16_256"] = {narrow!r}
    model = init_weights_(DPTDepthModel("swin2t16_256", input_size=(64, 128)),
                          torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        model.scratch.output_conv[4].bias.add_(0.5)
    cfg = config.from_dict({{"framework": {{"input_size": [64, 128], "native_size": [60, 80]}}}})
    u8 = np.random.default_rng(0).integers(0, 256, (1, 60, 80, 3), dtype=np.uint8)
    live = make_predict_step(model, cfg)
    out = {{}}
    for step in sys.argv[1].split(","):
        if step == "live":
            out["live"] = live(torch.from_numpy(u8)).numpy()
        else:
            bundle = E.export_predict(model, cfg, [1], platforms=["cpu"])
            E.save_exported(sys.argv[2], bundle)
            out["exported"] = E.load_exported(sys.argv[2], "cpu").predict(u8)
            ep = torch.export.load(io.BytesIO(bundle["programs"][("cpu", 1)]))
            constants = [[str(v.dtype), type(v).__name__] for v in ep.constants.values()]
    out["live_again"] = live(torch.from_numpy(u8)).numpy()
    print(json.dumps({{
        "max_abs": float(np.abs(out["exported"] - out["live"]).max()),
        "live_again_equal": bool(np.array_equal(out["live_again"], out["live"])),
        "spread": float(out["live"].max() - out["live"].min()),
        "kept": sorted({{type(v).__name__ for v in blocks._CONSTANTS.values()}}),
        "constants": constants}}))
''')


def test_device_constant_in_both_orders(tmp_path):
    script = ORDER_CHILD.format(threads=torch.get_num_threads(),
                                narrow=NARROW_SWIN["swin2t16_256"])
    procs = {order: subprocess.Popen(
        [sys.executable, "-c", script, order, str(tmp_path / f"{order}.mdex")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for order in ("export,live", "live,export")}
    for order, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (order, err[-3000:])
        got = json.loads(out.strip().splitlines()[-1])
        assert got["max_abs"] <= 1e-6 and got["live_again_equal"] and got["spread"] > 0, got
        assert got["kept"] == ["Tensor"], got  # no fake tensor kept from the trace
        # the indices, offsets and masks: constants of the program, one each
        assert ["torch.int64", "Tensor"] in got["constants"], got
        assert all(kind == "Tensor" for _, kind in got["constants"]), got
        assert len(got["constants"]) == 5, got
