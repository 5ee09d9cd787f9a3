"""The port's server over the (data, model) world, on the CPU over gloo.

The flagship of tests/test_torch_slice.py (64x96, DINOv2 at 28x42, weights
from a seed carried to the port by ``state_dict_from_flax``) is saved as a
checkpoint and served by ``python -m tests.torch_world_tool serve`` (the
port's CLI with its model at that DINOv2 size in every rank), which starts
its ranks itself:

(a) A (2, 2) world at ``--max-batch 4`` (buckets 1, 2, 4): groups of 1, 2,
    3 and 4 concurrent posts, a group a device step (a 1 s window), so that
    bucket 1 runs whole on data index 0 (it does not split over two) and
    buckets 2 and 4 split. Each reply equals one process's
    ``DepthService`` on the same bucket within 1e-5 of the map's largest
    absolute value (float32: the model ranks' Megatron sums run in another
    order), and mde_tpu's ``DepthService(..., mesh=make_mesh(2, 2))`` (its
    ``_predict_many``, parameters laid out by ``shard_params_tp``) within
    tests/test_torch_slice.py's bounds (rtol 2e-3, atol 2e-4: the port
    against JAX). ``X-Batch-Size`` is the group's size.
(b) SIGTERM to the launcher's process: every rank reports its stop, the
    launcher exits 0 within 60 s (every rank exited 0), and no rank is left.
(c) A rank that dies (SIGKILL) makes the launcher exit non-zero within 90 s
    (the launcher sees the rank's exit and stops the others), leaving no
    rank.
(d) ``mesh_world(cfg, device, batch_size)`` against ``make_training_mesh(cfg,
    batch_size)``'s axes over device counts, model axes, batches and
    requested data axes, without processes.
"""

import io
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core import config as jax_config
from mde_tpu.parallel import active_mesh, make_mesh, replicate, shard_params_tp
from mde_tpu.tools.serve import DepthService as JDepthService
from mde_tpu.train.trainer import TrainState
from mde_tpu_torch.core import config
from mde_tpu_torch.parallel import mesh
from mde_tpu_torch.tools.serve import DepthService
from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
from tests.test_torch_slice import flagship  # noqa: F401  (module fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = (60, 80)
GEOMETRY = {"framework": {"input_size": [64, 96], "native_size": list(NATIVE)},
            "experiment": {"model_name": "serve_world"}}
MAX_BATCH = 4
GROUPS = (1, 2, 3, 4)
TOL_WORLD = 1e-5  # of the map's largest absolute value, against one process
RTOL_JAX, ATOL_JAX = 2e-3, 2e-4  # tests/test_torch_slice.py's port-against-JAX bounds


def _stat(pid: int):
    """(state, parent, start time) of process ``pid``, or None when it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return fields[0], int(fields[1]), int(fields[19])


def _children(pid: int) -> list:
    """(pid, start time) of each process whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        stat = _stat(int(entry)) if entry.isdigit() else None
        if stat is not None and stat[1] == pid:
            out.append((int(entry), stat[2]))
    return out


def _left(ranks: list) -> list:
    """The ranks still running: the same process (its start time), not a
    zombie."""
    return [(pid, stat) for pid, start in ranks
            if (stat := _stat(pid)) is not None and stat[2] == start and stat[0] != "Z"]


class World:
    """``python -m tests.torch_world_tool serve`` at (data, model) and
    ``--max-batch``, its output read by a thread; ``url`` once rank 0
    serves."""

    def __init__(self, root, data: int, model: int, max_batch: int):
        argv = [sys.executable, "-m", "tests.torch_world_tool", "serve", "--device", "cpu",
                "--port", "0", "--max-batch", str(max_batch), "--window-ms", "1000",
                "--set", "framework.input_size=[64, 96]",
                "--set", f"framework.native_size={list(NATIVE)}",
                "--set", "experiment.model_name=serve_world",
                "--set", f"paths.results_dir={root}",
                "--set", f"framework.mesh.data={data}", "--set", f"framework.mesh.model={model}"]
        env = {**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1",
               "PYTHONPATH": REPO}
        # a session of its own, so that kill() reaches the ranks too
        self.proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        deadline = time.monotonic() + 180
        try:
            while not any(line.startswith("serving") for line in self.lines):
                assert self.proc.poll() is None, "".join(self.lines)
                assert time.monotonic() < deadline, "".join(self.lines)
                time.sleep(0.1)
        except BaseException:
            self.kill()
            raise
        line = next(line for line in self.lines if line.startswith("serving"))
        self.serving = line
        self.url = "http://127.0.0.1:" + line.split("127.0.0.1:")[1].split()[0]
        self.ranks = _children(self.proc.pid)

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def output(self) -> str:
        return "".join(self.lines)

    def kill(self):
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


def _post(url: str, img: np.ndarray):
    buf = io.BytesIO()
    np.save(buf, img)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.load(io.BytesIO(resp.read())), int(resp.headers["X-Batch-Size"])


def _post_group(url: str, images: np.ndarray) -> list:
    """Every image posted at once from its own thread; the replies in order."""
    replies = [None] * len(images)

    def client(i):
        replies[i] = _post(url, images[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None for r in replies)
    return replies


@pytest.fixture(scope="module")
def checkpoint(flagship, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("serve_world")
    save_checkpoint(checkpoint_path(str(root), "serve_world"), flagship[3])
    return root


@pytest.fixture(scope="module")
def world(checkpoint):
    w = World(checkpoint, 2, 2, MAX_BATCH)
    yield w
    if w.proc.poll() is None:
        w.kill()


def test_world_replies_match_one_process_and_jax_mesh(world, flagship):  # noqa: F811
    """(a)"""
    assert "rank 0 of 4 (data 0 of 2, model 0 of 2; gloo)" in world.serving
    assert "buckets (1, 2, 4)" in world.serving
    assert len(world.ranks) == 4
    jm, params, stats, port, _ = flagship
    rng = np.random.default_rng(5)
    groups = [rng.integers(0, 256, (n, *NATIVE, 3), dtype=np.uint8) for n in GROUPS]
    replies = [_post_group(world.url, images) for images in groups]

    one = DepthService(port, config.from_dict(GEOMETRY), "cpu", max_batch=MAX_BATCH)
    jmesh = make_mesh(2, 2)
    state = TrainState(step=jnp.asarray(0), params=shard_params_tp(params, jmesh),
                       batch_stats=replicate(stats, jmesh), opt_state=(), tx=None)
    jone = JDepthService(jm, state, jax_config.from_dict(GEOMETRY), mesh=jmesh,
                         max_batch=MAX_BATCH)
    try:
        for images, got in zip(groups, replies):
            bucket = one.batcher._bucket_for(len(images))
            padded = np.zeros((bucket, *NATIVE, 3), np.uint8)
            padded[:len(images)] = images
            want = one._predict_many(padded)
            with active_mesh(None):  # the windowed attention's XLA form, as the TP tests
                jwant = jone._predict_many(padded)
            for i, (depth, coalesced) in enumerate(got):
                assert coalesced == len(images)
                assert depth.shape == NATIVE and depth.dtype == np.float32
                scale = np.abs(want[i]).max()
                assert scale > 0
                assert np.abs(depth - want[i]).max() <= TOL_WORLD * scale, (len(images), i)
                np.testing.assert_allclose(depth, jwant[i], rtol=RTOL_JAX, atol=ATOL_JAX)
    finally:
        one.close()
        jone.batcher.close()


def test_sigterm_stops_every_rank_with_exit_zero(world):
    """(b)"""
    assert world.proc.poll() is None
    t0 = time.monotonic()
    world.proc.send_signal(signal.SIGTERM)
    assert world.proc.wait(timeout=60) == 0, world.output()
    assert time.monotonic() - t0 < 60
    world._reader.join(timeout=10)
    stopped = sorted(int(line.split()[1]) for line in world.lines if line.startswith("rank ")
                     and " stopped; steps by bucket " in line)
    assert stopped == [0, 1, 2, 3], world.output()
    assert not _left(world.ranks)


def test_a_dead_rank_ends_the_world(checkpoint):
    """(c): a (2, 1) world at --max-batch 2; rank 1 killed while it waits for
    rank 0's next header."""
    w = World(checkpoint, 2, 1, 2)
    try:
        assert len(w.ranks) == 2
        t0 = time.monotonic()
        os.kill(w.ranks[1][0], signal.SIGKILL)
        rc = w.proc.wait(timeout=90)
        assert rc != 0 and time.monotonic() - t0 < 90, w.output()
        assert "a rank exited with" in w.output()
        assert not _left(w.ranks)
    finally:
        if w.proc.poll() is None:
            w.kill()


MESH_CASES = [(n, t, b, d) for n in (1, 2, 4, 8) for t in (1, 2) for b in (1, 2, 3, 4, 8)
              for d in (-1, 2) if t <= n]


@pytest.mark.parametrize("devices,model,batch,data", MESH_CASES)
def test_mesh_world_takes_the_batch_as_make_training_mesh(monkeypatch, devices, model, batch,
                                                          data):
    """(d): the server's clamp to --max-batch, the tools' training.batch_size."""
    cfg, jcfg = config.defaults(), jax_config.defaults()
    cfg.training.batch_size = jcfg.training.batch_size = 5  # not the batch asked about
    for c in (cfg, jcfg):
        c.framework.mesh.data, c.framework.mesh.model = data, model
    monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
    monkeypatch.setattr(jax, "devices", lambda: list(range(devices)))
    monkeypatch.setattr("mde_tpu.parallel.mesh.make_mesh", lambda data, model: (data, model))
    from mde_tpu.parallel.mesh import make_training_mesh

    assert mesh.mesh_world(cfg, "cuda", batch) == make_training_mesh(jcfg, batch)
    assert mesh.mesh_world(cfg, "cuda") == make_training_mesh(jcfg, 5)
