"""The port runs without JAX, the JAX package, PIL and Triton.

The GPU machine has no JAX, and may lack PIL. A fresh interpreter with an
import hook that refuses ``jax``, ``jaxlib``, ``flax``, ``optax``,
``mde_tpu``, ``PIL`` and ``triton`` imports every module of
``mde_tpu_torch`` (Depth-Anything-V2, K4's, the evaluation, prediction, CSV
and visualisation tools, the profiling helpers, the export module, its CLI,
the conv+BN folding, the data-parallel modules and the rest of the model
zoo (LocalBins, U-Net, MidasNet over ResNeXt, DPT over the timm ViTs,
ResNetV2, BEiT, Swin, LeViT and Next-ViT, the MiDaS model loader and its
cv2 host transforms) among them, and the port's three examples
(``examples/torch_*.py``), with the
kernels' ``torch.library`` ops registered; matplotlib,
which imports PIL, only when a figure is drawn), builds DA-V2-S
through the factory and runs it on a small image, then writes a synthetic
dataset and decodes it through the loader (the zlib PNG writer and reader,
no PIL).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

BLOCKED = ("jax", "jaxlib", "flax", "optax", "mde_tpu", "PIL", "triton")

SCRIPT = textwrap.dedent('''
    import importlib, pkgutil, sys, tempfile, os

    BLOCKED = {blocked!r}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"import of {{name}} refused")

    sys.meta_path.insert(0, Refuse())
    import mde_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(mde_tpu_torch.__path__, "mde_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "mde_tpu_torch.models.depth_anything" in names
    assert all(n in names for n in ("mde_tpu_torch.tools.visualize", "mde_tpu_torch.utils",
                                    "mde_tpu_torch.tools.evaluation",
                                    "mde_tpu_torch.train.profiling",
                                    "mde_tpu_torch.train.export",
                                    "mde_tpu_torch.tools.export_model",
                                    "mde_tpu_torch.nn.fuse",
                                    "mde_tpu_torch.parallel.distributed",
                                    "mde_tpu_torch.parallel.mesh",
                                    "mde_tpu_torch.parallel.sync_batchnorm",
                                    "mde_tpu_torch.parallel.launch",
                                    "mde_tpu_torch.models.localbins",
                                    "mde_tpu_torch.models.simple_unet",
                                    "mde_tpu_torch.models.midas_net",
                                    "mde_tpu_torch.models.dpt",
                                    "mde_tpu_torch.nn.resnext",
                                    "mde_tpu_torch.nn.resnetv2",
                                    "mde_tpu_torch.nn.beit",
                                    "mde_tpu_torch.nn.swin",
                                    "mde_tpu_torch.nn.levit",
                                    "mde_tpu_torch.nn.next_vit",
                                    "mde_tpu_torch.models.model_loader",
                                    "mde_tpu_torch.data.midas_transforms"))
    for name in ("examples.torch_simple_unet_baseline", "examples.torch_midas_finetune",
                 "examples.torch_da2_finetune"):
        importlib.import_module(name)  # the port's examples, not package modules
    assert "matplotlib" not in sys.modules
    import torch
    assert all(hasattr(torch.ops.mde_tpu, op)
               for op in ("preprocess_u8", "window_attention", "flash_attention"))
    from mde_tpu_torch.core import config
    from mde_tpu_torch.models.factory import build_model
    cfg = config.defaults()
    cfg.model.model_type = "DepthAnythingV2_vits"
    model = build_model(cfg.model, "cpu", torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        assert model(torch.zeros(1, 3, 28, 42)).shape == (1, 28, 42)
    from mde_tpu_torch.data import dataset, loader, native, synthetic
    native.available = lambda: False  # decode through the port's own PNG reader
    with tempfile.TemporaryDirectory() as root:
        synthetic.generate(root, n_train=3, n_test=1, size=(12, 16), seed=0)
        ds = dataset.DepthDataset(os.path.join(root, "train"), os.path.join(root, "train_list.txt"))
        batches = list(loader.HostLoader(ds, batch_size=3))
        assert batches[0]["rgb"].shape == (3, 12, 16, 3), batches[0]["rgb"].shape
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names))
''').format(blocked=BLOCKED)


def test_port_imports_and_loads_data_without_jax_pil_or_triton():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parent.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 63  # every module of the package was imported
