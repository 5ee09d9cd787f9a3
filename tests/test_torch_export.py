"""The port's serving artifact (train/export.py, tools/export_model.py and
``serve --exported``) on the CPU, against the port's live predict step and the
JAX package's predict step.

Two models at the gate's small geometry, each exported once per module with
buckets (1, 2): the flagship of tests/test_torch_slice.py (64x96 input, DINOv2
at 28x42, LayerScale gammas and BN statistics randomised, native 60x80) and
DA-V2-S at full width on a 56x84 input (4x6 tokens, gammas in [0.2, 0.8] as in
tests/test_torch_da2.py, native 60x80), both with JAX weights carried over
through ``state_dict_from_flax``.

Tolerances:
- exported predictor against the port's live ``make_predict_step``: rtol 0,
  atol 1e-6. Both run the same float32 operations on the CPU (the ops' CPU
  implementations are the plain versions the live step takes there); export
  may write a composite operation out in its parts, which can move the last
  ulp of a depth below 10 (1e-6).
- exported predictor against mde_tpu's ``make_predict_step``: rtol 2e-3,
  atol 2e-4 and corrcoef > 0.9999, tests/test_torch_slice.py's bounds for the
  live step: float32 rounding through the whole network and its resizes.
- served replies against the live service's: rtol 1e-5, atol 1e-6, the bound
  of tests/test_torch_serve.py for a reply batched with other requests.
- the fused model (nn/fuse.py) is tests/test_torch_fuse.py's subject.
"""

import io
import json
import subprocess
import sys
import threading
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.train import export as jax_export
from mde_tpu.train.trainer import TrainState, make_predict_step as jax_predict_step
from mde_tpu_torch.core import config
from mde_tpu_torch.models.depth_anything import DepthAnythingV2
from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.ops import kernels as K
from mde_tpu_torch.tools import common, export_model
from mde_tpu_torch.tools.serve import (DepthService, build_service_from_exported,
                                       make_handler)
from mde_tpu_torch.train import export as E
from mde_tpu_torch.train.checkpoint import checkpoint_path, load_state_dict, save_checkpoint
from mde_tpu_torch.train.convert import state_dict_from_flax
from mde_tpu_torch.train.trainer import make_predict_step
from tests.test_torch_da2 import da2_params
from tests.test_torch_slice import DINO, GEOMETRY, flagship  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BUCKETS = (1, 2)
NATIVE = (60, 80)
DA2_SIZE = (56, 84)
DA2_GEOMETRY = {"model": {"model_type": "DepthAnythingV2_vits"},
                "framework": {"input_size": list(DA2_SIZE), "native_size": list(NATIVE)}}
# the kernels' nodes in each bucket's graph: K3, K1 and K4 (12 DINOv2 blocks)
WANT_OPS = {
    "flagship": {"preprocess_u8": 1, "window_attention": 1, "flash_attention": 12},
    "da2": {"preprocess_u8": 1, "flash_attention": 12},
}


def _export(port, geometry, path):
    cfg = config.from_dict(geometry)
    bundle = E.export_predict(port, cfg, BUCKETS, platforms=["cpu"])
    E.save_exported(str(path), bundle)
    return cfg, bundle


@pytest.fixture(scope="module")
def models(flagship, tmp_path_factory):  # noqa: F811
    """{name: (port model, port cfg, jax model, jax state, jax cfg, archive path, bundle)}."""
    root = tmp_path_factory.mktemp("export")
    jm, params, stats, port, _ = flagship
    cfg, bundle = _export(port, GEOMETRY, root / "flagship.mdex")
    out = {"flagship": (port, cfg, jm, TrainState(step=jnp.asarray(0), params=params,
                                                   batch_stats=stats, opt_state=(), tx=None),
                        jax_config.from_dict(GEOMETRY), root / "flagship.mdex", bundle)}
    djm, dparams = da2_params(DA2_SIZE, seed=2)
    dport = DepthAnythingV2("vits").eval()
    load_state_dict(dport, state_dict_from_flax(dparams, {}, "DepthAnythingV2"))
    dcfg, dbundle = _export(dport, DA2_GEOMETRY, root / "da2.mdex")
    out["da2"] = (dport, dcfg, djm, TrainState(step=jnp.asarray(0), params=dparams,
                                               batch_stats={}, opt_state=(), tx=None),
                  jax_config.from_dict(DA2_GEOMETRY), root / "da2.mdex", dbundle)
    return out


def _batch(seed: int, b: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, *NATIVE, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", ["flagship", "da2"])
def test_exported_predictor_matches_live_step(models, name):
    port, cfg, *_, path, _ = models[name]
    predictor = E.load_exported(str(path), "cpu")
    assert predictor.batch_sizes == list(BUCKETS) and predictor.meta["platforms"] == ["cpu"]
    for b in BUCKETS:
        u8 = _batch(b, b)
        got = predictor.predict(u8)
        want = make_predict_step(port, cfg)(torch.from_numpy(u8)).numpy()
        assert got.shape == (b, *NATIVE) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert K._lib is None  # the CPU programs ran the plain versions: no library was loaded


@pytest.mark.parametrize("name", ["flagship", "da2"])
def test_exported_predictor_matches_jax(models, name):
    *_, jm, state, jcfg, path, _ = models[name]
    u8 = _batch(7, 2)
    want = np.asarray(jax_predict_step(jm, jcfg)(state, jnp.asarray(u8)))
    got = E.load_exported(str(path), "cpu").predict(u8)
    assert (want > 0).mean() > 0.5 and float(want.std()) > 1e-3
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("name", ["flagship", "da2"])
def test_each_bucket_graph_holds_the_kernel_ops(models, name):
    """Every call in each bucket's graph is an ATen op or one of the mde_tpu
    ops (besides tuple indexing): the kernels are the ops' nodes, and nothing
    else (no ctypes call, no plain version written out) stands for them."""
    bundle = models[name][-1]
    for b in BUCKETS:
        ep = torch.export.load(io.BytesIO(bundle["programs"][("cpu", b)]))
        targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
        ops = {}
        for t in targets:
            if isinstance(t, torch._ops.OpOverload) and t.namespace == K.OPS_NAMESPACE:
                ops[t._opname] = ops.get(t._opname, 0) + 1
        assert ops == WANT_OPS[name], (b, ops)
        others = {t for t in targets if not isinstance(t, torch._ops.OpOverload)}
        assert all(getattr(t, "__name__", "") == "getitem" for t in others), others
        assert {t.namespace for t in targets if isinstance(t, torch._ops.OpOverload)} <= {
            "aten", K.OPS_NAMESPACE}
        # the weights are inputs, not state: the program holds only small constants
        assert not ep.state_dict and sum(c.numel() for c in ep.constants.values()) < 10_000


def _opcheck_cases():
    g = torch.Generator().manual_seed(0)
    u8 = torch.randint(0, 256, (2, 10, 12, 3), dtype=torch.uint8, generator=g)
    q, k, v = (torch.randn(2, 3, 16, 32, generator=g) for _ in range(3))
    valid = torch.ones(3, 16)
    valid[2, 10:] = 0
    qkv = torch.randn(2, 20, 3, 6, 64, generator=g)  # the ViT's fused projection
    fq, fk, fv = qkv.unbind(2)
    return [
        ("preprocess_u8", K.preprocess_u8_op, (u8, 16, 20)),
        ("window_attention", K.window_attention_op, (q, k, v, valid, 8, False)),
        ("window_attention_stats", K.window_attention_op, (q, k, v, valid, 8, True)),
        ("flash_attention", K.flash_attention_op, (fq, fk, fv, False)),
        ("flash_attention_lse", K.flash_attention_op, (fq, fk, fv, True)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_opcheck(case):
    _, op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


def test_ops_cpu_implementation_is_the_plain_version():
    (_, _, (u8, h, w)), (_, _, wa), _, (_, _, fa), (_, _, fa_lse) = _opcheck_cases()
    assert torch.equal(K.preprocess_u8_op(u8, h, w), K.preprocess_u8_plain(u8, (h, w)))
    q, k, v, valid, heads, _ = wa
    out, stats = K.window_attention_op(*wa)
    assert torch.equal(out, K.window_attention_plain(q, k, v, heads, valid)) and stats.numel() == 0
    out, lse = K.flash_attention_op(*fa_lse)
    want, want_lse = K.flash_attention_plain_lse(*fa_lse[:3])
    assert torch.equal(out, want) and torch.equal(lse, want_lse) and out.is_contiguous()


def _rewrite(src: Path, dst: Path, edit=None, extra=None) -> Path:
    """A copy of an archive with its meta edited and extra members added."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item)
            if item.filename == E.META_NAME and edit:
                meta = json.loads(data)
                edit(meta)
                data = json.dumps(meta).encode()
            zout.writestr(item, data)
        for name, data in (extra or {}).items():
            zout.writestr(name, data)
    return dst


def test_refusals(models, tmp_path):
    path = models["flagship"][-2]
    predictor = E.load_exported(str(path), "cpu")
    with pytest.raises(ValueError, match="no exported bucket for batch 3"):
        predictor.predict(_batch(0, 3))
    with pytest.raises(ValueError, match="uint8 batch"):
        predictor.predict(_batch(0, 1).astype(np.float32))
    with pytest.raises(ValueError, match="uint8 batch"):
        predictor.predict(_batch(0, 1)[:, :, :-1])
    bad = _rewrite(path, tmp_path / "v9.mdex", lambda m: m.update(format_version=9))
    with pytest.raises(ValueError, match="unsupported artifact format 9"):
        E.load_exported(str(bad))
    with pytest.raises(ValueError, match=r"exported for platforms \['cpu'\]"):
        E.load_exported(str(path), "cuda")
    with pytest.raises(ValueError, match="unknown platform"):
        E.export_predict(models["flagship"][0], models["flagship"][1], [1], platforms=["tpu"])
    # an archive as mde_tpu's writer lays it out
    jax_path = tmp_path / "jax.mdex"
    jax_export.save_exported(str(jax_path), {
        "meta": {"format_version": jax_export.FORMAT_VERSION, "batch_sizes": [1],
                 "platforms": ["cpu"]},
        "blobs": {1: b"stablehlo"}, "weights": b"msgpack"})
    with pytest.raises(ValueError, match="mde_tpu \\(JAX\\) artifact.*state_dict_from_flax"):
        E.load_exported(str(jax_path), "cpu")


def test_weights_stored_once(models, tmp_path):
    """The archive at buckets (1, 2, 4, 8) is larger than at (1) by the three
    programs, well below one copy of the weights."""
    port, cfg, *_, bundle = models["flagship"]
    more = E.export_predict(port, cfg, (4, 8), platforms=["cpu"])
    sizes = {}
    for buckets in ((1,), (1, 2, 4, 8)):
        programs = {**bundle["programs"], **more["programs"]}
        meta = {**bundle["meta"], "batch_sizes": list(buckets)}
        path = tmp_path / f"{len(buckets)}.mdex"
        E.save_exported(str(path), {"meta": meta, "weights": bundle["weights"], "programs": {
            ("cpu", b): programs[("cpu", b)] for b in buckets}})
        sizes[buckets] = path.stat().st_size
    weights = len(bundle["weights"])
    assert weights > 100e6  # the flagship's 51M float32 parameters
    assert sizes[(1,)] < 1.05 * weights
    assert sizes[(1, 2, 4, 8)] - sizes[(1,)] < 0.1 * weights
    with zipfile.ZipFile(tmp_path / "4.mdex") as zf:
        names = zf.namelist()
        assert sorted(names) == sorted([E.META_NAME, E.WEIGHTS_NAME]
                                       + [f"cpu/b{b}.pt2" for b in (1, 2, 4, 8)])
        assert all(i.compress_type == zipfile.ZIP_STORED for i in zf.infolist())
    predictor = E.load_exported(str(tmp_path / "4.mdex"), "cpu")
    u8 = _batch(4, 4)
    np.testing.assert_allclose(predictor.predict(u8),
                               make_predict_step(port, cfg)(torch.from_numpy(u8)).numpy(),
                               rtol=0, atol=1e-6)


def test_fresh_process_loads_without_model_code(models):
    """A new interpreter loads the archive and predicts with no module of
    mde_tpu_torch.models imported, and gives the bits of this process.

    The child runs at this process's thread count: the CPU convolutions and
    GEMMs split their sums by thread count, so the same program at another
    count rounds differently (at the machine's default of 8 threads against
    this module's 2: 1,615 of 9,600 elements apart, by up to 8.94e-8). The
    comparison stays bit for bit: same program, same threads, same bits."""
    path = models["da2"][-2]
    u8 = _batch(11, 2)
    script = (
        "import sys, numpy as np, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "from mde_tpu_torch.train.export import load_exported\n"
        f"p = load_exported({str(path)!r}, 'cpu')\n"
        f"u8 = np.random.default_rng(11).integers(0, 256, (2, {NATIVE[0]}, {NATIVE[1]}, 3), "
        "dtype=np.uint8)\n"
        "np.save(sys.stdout.buffer, p.predict(u8))\n"
        "sys.stderr.write(repr(sorted(m for m in sys.modules "
        "if m.startswith('mde_tpu_torch.models') or m == 'mde_tpu' "
        "or m.startswith('mde_tpu.'))))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert proc.stderr.decode().strip().splitlines()[-1] == "[]"
    got = np.load(io.BytesIO(proc.stdout))
    want = E.load_exported(str(path), "cpu").predict(u8)
    np.testing.assert_array_equal(got, want)


def _post(url: str, body: bytes):
    req = urllib.request.Request(f"{url}/predict", data=body, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.load(io.BytesIO(resp.read())), int(resp.headers["X-Batch-Size"])


def _npy(img) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def test_serve_exported_matches_live_service(models):
    port, cfg, *_, path, _ = models["flagship"]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    service = build_service_from_exported(cfg, str(path), "cpu", window_ms=200.0)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    live = DepthService(port, cfg, "cpu", max_batch=2, window_ms=1.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert service.model is None and service.model_name == cfg.experiment.model_name
        assert service.batcher.buckets == BUCKETS
        url = f"http://127.0.0.1:{server.server_address[1]}"
        imgs = list(_batch(5, 4))
        with ThreadPoolExecutor(4) as pool:
            replies = list(pool.map(lambda img: _post(url, _npy(img)), imgs))
        assert max(n for _, n in replies) == 2  # requests coalesced into a bucket
        for img, (depth, _) in zip(imgs, replies):
            want, _ = live.batcher.submit(img)
            assert depth.shape == NATIVE and depth.dtype == np.float32
            np.testing.assert_allclose(depth, want, rtol=1e-5, atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        live.close()


def test_serve_exported_refuses_mismatches(models, tmp_path):
    _, cfg, *_, path, _ = models["flagship"]
    other = config.from_dict({"framework": {"input_size": [64, 96], "native_size": [64, 96]}})
    with pytest.raises(ValueError, match="native_size"):
        build_service_from_exported(other, str(path), "cpu", warmup=False)
    odd = _rewrite(path, tmp_path / "b2.mdex", lambda m: m.update(batch_sizes=[2]))
    with pytest.raises(ValueError, match="buckets"):
        build_service_from_exported(cfg, str(odd), "cpu", warmup=False)


def test_export_cli(flagship, tmp_path, monkeypatch, capsys):  # noqa: F811
    """The CLI refuses to export without a checkpoint, then exports the
    checkpoint's weights at the bucket ladder of --max-batch."""
    def build_model(model_cfg, device, generator):
        return init_weights_(MidasNetSemantics(dinov2_image_size=DINO), generator).to(device)

    monkeypatch.setattr(common, "build_model", build_model)
    port, out = flagship[3], tmp_path / "model.mdex"
    argv = ["--device", "cpu", "--out", str(out), "--max-batch", "2",
            "--set", f"paths.results_dir={tmp_path}",
            "--set", "framework.input_size=[64,96]", "--set", "framework.native_size=[60,80]"]
    with pytest.raises(FileNotFoundError, match="refusing to export"):
        export_model.main(argv)
    cfg = config.from_dict(GEOMETRY)
    save_checkpoint(checkpoint_path(str(tmp_path), cfg.experiment.model_name), port)
    meta = export_model.main(argv)
    assert f"Wrote {out}" in capsys.readouterr().out
    assert meta["batch_sizes"] == [1, 2] and meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__ and meta["native_size"] == list(NATIVE)
    u8 = _batch(9, 1)
    np.testing.assert_allclose(E.load_exported(str(out), "cpu").predict(u8),
                               make_predict_step(port, cfg)(torch.from_numpy(u8)).numpy(),
                               rtol=0, atol=1e-6)
