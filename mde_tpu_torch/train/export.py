"""Ahead-of-time serving artifact: one ``torch.export`` program per batch
bucket over one weights blob (port of mde_tpu/train/export.py).

The predict step (train/trainer.py::make_predict_step: ``preprocess_eval`` ->
the model in eval mode -> align-corners resize to the native 426x560) is
exported once per batch bucket and platform. Its two inputs are the weights
(the reference-grammar state_dict, parameters and buffers, applied with
``torch.func.functional_call``) and the (b, H, W, 3) uint8 batch, so no program
holds a copy of the weights. The kernels of the path are ``torch.library`` ops
(ops/kernels.py: ``mde_tpu::preprocess_u8``, ``mde_tpu::window_attention``,
``mde_tpu::flash_attention``), each one node of the graph: a program run on a
CUDA device launches the kernels, on the CPU their plain versions.

Archive (a zip): ``meta.json`` (model name and type, geometry, buckets,
platforms, torch version), ONE ``weights.pt`` (``torch.save`` of the
state_dict) and one ``{platform}/b{N}.pt2`` per platform and bucket
(``torch.export.save``, without the example inputs, which would be a copy of
the weights), all stored uncompressed. ``ExportedPredictor`` needs no model
code: it copies the weights to its device once, deserialises a bucket's
program when the bucket is first used and runs it under
``torch.inference_mode()``.

A platform's programs are traced on that platform's device, so that the
devices recorded in the graph are its own: ``cuda`` needs a visible card.
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops import kernels  # noqa: F401  (registers the mde_tpu ops the programs call)

META_NAME = "meta.json"
WEIGHTS_NAME = "weights.pt"
MDE_TPU_WEIGHTS_NAME = "weights.msgpack"  # the JAX package's artifact
FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")


def _program_name(platform: str, batch: int) -> str:
    return f"{platform}/b{int(batch)}.pt2"


class _PredictProgram(torch.nn.Module):
    """forward(weights, rgb_u8): the predict step with the weights an input.
    The model is no submodule, so that none of its tensors is state of the
    exported program."""

    def __init__(self, model, input_size, native):
        super().__init__()
        self.__dict__["model"] = model
        self.input_size = tuple(input_size)
        self.native = tuple(native)

    def forward(self, weights: dict, rgb_u8: torch.Tensor) -> torch.Tensor:
        from ..data.transforms import preprocess_eval
        from ..ops.resize import resize_bilinear

        rgb = preprocess_eval(rgb_u8, input_size=self.input_size)
        pred = torch.func.functional_call(self.model, weights, (rgb,))
        return resize_bilinear(pred, self.native, align_corners=True)


def _platform_device(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; have {list(PLATFORMS)}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise ValueError("exporting for cuda needs a visible CUDA device: a program is traced "
                         "on its platform's device (export the cpu platform here, or run on a "
                         "machine with a card)")
    return torch.device(platform)


def export_predict(model, cfg, batch_sizes: Sequence[int],
                   platforms: Optional[Sequence[str]] = None) -> dict:
    """Export the predict step of ``model`` (its current weights) for each
    batch size and platform; the weights are an input, shared across buckets.

    Returns {"meta": dict, "programs": {(platform, batch): bytes}, "weights":
    bytes}; the meta's ``export_seconds`` holds each program's time to export
    and serialise. ``platforms`` defaults to the device the model is on.
    """
    native = tuple(int(s) for s in cfg.framework.native_size)
    input_size = tuple(int(s) for s in cfg.framework.input_size)
    state = model.state_dict()
    plats = tuple(platforms) if platforms else (next(iter(state.values())).device.type,)
    devices = {p: _platform_device(p) for p in plats}
    host_weights = {k: v.detach().cpu() for k, v in state.items()}
    was_training = model.training
    model.eval()
    programs, seconds = {}, {}
    try:
        for plat, device in devices.items():
            # every tensor of the model is in its state_dict, so the copy on
            # ``device`` replaces all of them wherever the model itself is
            weights = {k: v.to(device) for k, v in host_weights.items()}
            program = _PredictProgram(model, input_size, native)
            for b in batch_sizes:
                t0 = time.perf_counter()
                spec = torch.zeros((int(b), *native, 3), dtype=torch.uint8, device=device)
                with torch.no_grad():
                    ep = torch.export.export(program, (weights, spec))
                ep.example_inputs = None  # else saved: a copy of the weights a program
                buf = io.BytesIO()
                torch.export.save(ep, buf)
                programs[(plat, int(b))] = buf.getvalue()
                seconds.setdefault(plat, {})[str(int(b))] = time.perf_counter() - t0
    finally:
        model.train(was_training)
    blob = io.BytesIO()
    torch.save(host_weights, blob)
    meta = {
        "format_version": FORMAT_VERSION,
        "model_name": str(cfg.experiment.model_name),
        "model_type": str(cfg.model.model_type),
        "native_size": list(native),
        "input_size": list(input_size),
        "batch_sizes": sorted(int(b) for b in batch_sizes),
        "platforms": list(plats),
        "torch_version": torch.__version__,
        "export_seconds": seconds,
    }
    return {"meta": meta, "programs": programs, "weights": blob.getvalue()}


def save_exported(path: str, exported: dict) -> None:
    """Write the {meta, programs, weights} bundle as a zip archive."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr(META_NAME, json.dumps(exported["meta"], indent=2))
        zf.writestr(WEIGHTS_NAME, bytes(exported["weights"]))
        for (plat, b), blob in sorted(exported["programs"].items()):
            zf.writestr(_program_name(plat, b), bytes(blob))
    os.replace(tmp, path)


class ExportedPredictor:
    """A deserialised archive on ``device``: bucketed ``predict(rgb_u8)`` with
    no model code. The weights are copied to the device once, here; a
    bucket's program is deserialised when the bucket is first used."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = torch.device(device)
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            if MDE_TPU_WEIGHTS_NAME in names:
                raise ValueError(
                    f"{path} is an mde_tpu (JAX) artifact ({MDE_TPU_WEIGHTS_NAME} inside): its "
                    "programs are jax.export StableHLO, which this package cannot run; carry "
                    "the weights over with train/convert.py::state_dict_from_flax and export "
                    "them with python -m mde_tpu_torch.tools.export_model")
            self.meta = json.loads(zf.read(META_NAME))
            version = self.meta.get("format_version")
            if version != FORMAT_VERSION:
                raise ValueError(f"{path}: unsupported artifact format {version!r} "
                                 f"(this package reads {FORMAT_VERSION})")
            if self.device.type not in self.meta["platforms"]:
                raise ValueError(f"{path}: exported for platforms {self.meta['platforms']}, "
                                 f"the predictor's device is {self.device}")
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise ValueError(f"{path}: device {self.device} asked for, but no CUDA device "
                                 "is visible")
            plat = self.device.type
            self._raw = {b: zf.read(_program_name(plat, b)) for b in self.meta["batch_sizes"]}
            host = torch.load(io.BytesIO(zf.read(WEIGHTS_NAME)), map_location="cpu",
                              weights_only=True)
        self._weights = {k: v.to(self.device) for k, v in host.items()}
        self._calls: dict[int, Callable] = {}

    @property
    def batch_sizes(self) -> list[int]:
        return list(self.meta["batch_sizes"])

    def _call_for(self, batch: int) -> Callable:
        fn = self._calls.get(batch)
        if fn is None:
            if batch not in self._raw:
                raise ValueError(
                    f"no exported bucket for batch {batch}; have {self.batch_sizes}")
            fn = torch.export.load(io.BytesIO(self._raw[batch])).module()
            self._calls[batch] = fn
        return fn

    def predict_tensor(self, rgb_u8: torch.Tensor) -> torch.Tensor:
        """(N, H_native, W_native, 3) uint8 on the device -> (N, H_native,
        W_native) float32 on the device, enqueued and not waited for. The
        program checks all its inputs against their exported shapes on a
        bucket's first call only (a host cost that grows with the number
        of weights); later calls check only the batch, here: the weights
        are this predictor's own. Float32 precision is the process's: the
        server turns TF32 off (``tools/common.py::set_float32_precision``)."""
        b = int(rgb_u8.shape[0])
        fn = self._call_for(b)
        want = (b, *self.meta["native_size"], 3)
        if (tuple(rgb_u8.shape) != want or rgb_u8.dtype != torch.uint8
                or rgb_u8.device.type != self.device.type):
            raise ValueError(f"expected a {want} uint8 batch on {self.device}, got "
                             f"{tuple(rgb_u8.shape)} {rgb_u8.dtype} on {rgb_u8.device}")
        with torch.inference_mode():
            out = fn(self._weights, rgb_u8)
        fn.validate_inputs = False
        return out

    def predict(self, rgb_u8: np.ndarray) -> np.ndarray:
        """(N, H_native, W_native, 3) uint8 -> (N, H_native, W_native) float32.
        N must be one of the exported buckets (compose with the serving
        batcher, which pads to bucket sizes)."""
        x = torch.from_numpy(np.ascontiguousarray(rgb_u8)).to(self.device)
        return self.predict_tensor(x).cpu().numpy()


def load_exported(path: str, device="cuda") -> ExportedPredictor:
    return ExportedPredictor(path, device)
