"""Does Depth-Anything-V2-S's depth map collapse to zero under a short fit
in both packages, or in the port alone? On the CPU.

Both packages' ``fit`` train DA-V2-S from the same weights (mde_tpu's init,
or with ``--start port`` the port factory's, carried across by
``state_dict_from_flax`` and ``import_state_dict``) on the same generated data
(``mde_tpu_torch.data.synthetic.generate``: 16 train and 4 test images, as
the smoke run's training CLI uses, here at a small geometry), float32, the
default optimiser and losses. After each epoch, at the epoch's first
validation batch, the weights of each are run by the port's DA-V2 on one
fixed batch and the final 1x1 conv's output before its ReLU is read: its
min, max, mean and the share above 0 (0 is a collapsed map: every depth at
the ReLU). Prints a JSON line an epoch and package, then one summary line.
``--bias`` raises the shared start's final bias (mde_tpu's init leaves the
whole map at the ReLU at this geometry, where nothing trains).

    python scripts/fit_collapse.py [--epochs 6] [--bias 0.5] [--size 60 80] [--input 56 84]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mde_tpu.core import config as jax_config  # noqa: E402
from mde_tpu.data.transforms import preprocess_eval as jax_preprocess_eval  # noqa: E402
from mde_tpu.models import factory as jax_factory  # noqa: E402
from mde_tpu.tools import common as jax_common  # noqa: E402
from mde_tpu.train import torch_import  # noqa: E402
from mde_tpu.train import trainer as jax_trainer  # noqa: E402
from mde_tpu_torch.core import config  # noqa: E402
from mde_tpu_torch.data import synthetic  # noqa: E402
from mde_tpu_torch.data.transforms import preprocess_eval  # noqa: E402
from mde_tpu_torch.models import factory  # noqa: E402
from mde_tpu_torch.tools import common  # noqa: E402
from mde_tpu_torch.train import trainer  # noqa: E402
from mde_tpu_torch.train.checkpoint import load_state_dict  # noqa: E402
from mde_tpu_torch.train.convert import state_dict_from_flax  # noqa: E402


def _cfg(module, args, root, tag):
    cfg = module.defaults()
    cfg.model.model_type = "DepthAnythingV2_vits"
    cfg.framework.input_size = list(args.input)
    cfg.framework.native_size = list(args.size)
    cfg.framework.compute_dtype = "float32"
    cfg.framework.num_workers = 0
    cfg.training.n_epoch = args.epochs
    cfg.experiment.wandb_disable = True
    cfg.paths.data_dir = os.path.join(root, "data")
    cfg.paths.results_dir = os.path.join(root, tag)
    os.makedirs(cfg.paths.results_dir, exist_ok=True)
    return cfg


def pre_relu(model, rgb_u8: np.ndarray, size) -> dict:
    """The final 1x1 conv's output before the ReLU on ``rgb_u8``, eval mode."""
    seen = []
    conv = model.depth_head.scratch.output_conv2[2]
    hook = conv.register_forward_hook(lambda m, i, o: seen.append(o.detach()))
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(preprocess_eval(torch.from_numpy(rgb_u8), input_size=size))
    finally:
        hook.remove()
        model.train(was_training)
    z = seen[0]
    return {"min": z.min().item(), "max": z.max().item(), "mean": z.mean().item(),
            "share_above_0": (z > 0).float().mean().item()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--size", type=int, nargs=2, default=(60, 80), help="generated images")
    p.add_argument("--input", type=int, nargs=2, default=(56, 84), help="the model's input")
    p.add_argument("--bias", type=float, default=0.0,
                   help="added to the final conv's bias of the shared start (mde_tpu's init "
                        "leaves every pre-ReLU value of this geometry below 0)")
    p.add_argument("--start", choices=("jax", "port"), default="jax",
                   help="whose init both start from: mde_tpu's, or the port factory's (seed 0, "
                        "as the port's training CLI draws it), carried to JAX by "
                        "import_state_dict with mde_tpu's DA-V2 map")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    size = tuple(args.input)
    root = tempfile.mkdtemp(prefix="fit_collapse_")
    synthetic.generate(os.path.join(root, "data"), n_train=16, n_test=4, size=tuple(args.size),
                       seed=0)

    jcfg = _cfg(jax_config, args, root, "jax")
    jmodel = jax_factory.build_model(jcfg.model)
    state = jax_trainer.create_train_state(
        jmodel, jax.random.key(0), jax_preprocess_eval(
            jnp.zeros((1, *args.size, 3), jnp.uint8), None, input_size=size, has_depth=False),
        jcfg)
    params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
    cfg = _cfg(config, args, root, "port")
    model = factory.build_model(cfg.model, "cpu", torch.Generator().manual_seed(0))
    if args.start == "port":
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, _, report = torch_import.import_state_dict(sd, params, {},
                                                           torch_import.map_depth_anything_key)
        assert not report["shape_mismatch"], report
        params = jax.tree_util.tree_map(np.array, params)
    params["final"]["Conv_0"]["bias"] += args.bias
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    init = state_dict_from_flax(params, jax.device_get(state.batch_stats), "DepthAnythingV2")
    report = load_state_dict(model, init)
    assert not report["unexpected"] and not report["shape_mismatch"], report
    probe_model = factory.build_model(cfg.model, "cpu", torch.Generator().manual_seed(0))
    loaders = common.build_loaders(cfg, common.resolve_paths(cfg))
    probe = next(iter(loaders["val"]))["rgb"]
    probe = np.asarray(probe)

    readings = {"jax": [], "port": []}
    before = pre_relu(model, probe, size)
    for tag in readings:
        readings[tag].append({"epoch": 0, **before})
        print(json.dumps({"package": tag, "epoch": 0, **before}), flush=True)

    def watch(tag, params_of, n_val):
        """make_eval_step, reading the weights at each epoch's first val batch."""
        calls = [0]

        def wrap(make):
            def make_eval_step(*a, **k):
                step = make(*a, **k)

                def run(*sa, **sk):
                    if calls[0] % n_val == 0:
                        epoch = calls[0] // n_val + 1
                        r = {"epoch": epoch, **pre_relu(params_of(sa), probe, size)}
                        readings[tag].append(r)
                        print(json.dumps({"package": tag, **r}), flush=True)
                    calls[0] += 1
                    return step(*sa, **sk)
                return run
            return make_eval_step
        return wrap

    def jax_weights(step_args):
        st = step_args[0]
        load_state_dict(probe_model, state_dict_from_flax(
            jax.device_get(st.params), jax.device_get(st.batch_stats), "DepthAnythingV2"))
        return probe_model

    jloaders = jax_common.build_loaders(jcfg, jax_common.resolve_paths(jcfg))
    jax_trainer.make_eval_step = watch("jax", jax_weights, len(jloaders["val"]))(
        jax_trainer.make_eval_step)
    _, jhist = jax_trainer.fit(jmodel, jcfg, state, jloaders["train"], jloaders["val"],
                               jcfg.paths.results_dir)

    trainer.make_eval_step = watch("port", lambda _: model, len(loaders["val"]))(
        trainer.make_eval_step)
    hist = trainer.fit(model, cfg, trainer.make_optimizer(model, cfg), loaders["train"],
                       loaders["val"], cfg.paths.results_dir)
    print(json.dumps({"summary": {
        tag: {"share_above_0": [r["share_above_0"] for r in rs], "max": [r["max"] for r in rs]}
        for tag, rs in readings.items()},
        "train_loss": {"jax": jhist["train_loss"], "port": hist["train_loss"]},
        "val_loss": {"jax": jhist["val_loss"], "port": hist["val_loss"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
