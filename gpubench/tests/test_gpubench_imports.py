"""Nothing the benchmark runs loads JAX or the JAX package: ``run.py`` and
every reference, traffic, metric and harness module are imported (with the
program's modules that the drivers use) in a fresh interpreter where
``jax``, ``jaxlib``, ``flax`` and ``mde_tpu`` are refused, compared by whole
top-level name, so that ``mde_tpu_torch`` passes."""

import json
import subprocess
import sys

from gpubench.harness import cli, spec

CHILD = r"""
import importlib, importlib.util, json, sys
REFUSED = {"jax", "jaxlib", "flax", "mde_tpu"}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in REFUSED:
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
root, modules, files = json.loads(sys.argv[1])
sys.path.insert(0, root)
for path in files:
    spec = importlib.util.spec_from_file_location("m_" + str(abs(hash(path))), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in modules:
    importlib.import_module(name)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

PROGRAM = ["mde_tpu_torch.tools.serve", "mde_tpu_torch.tools.common", "mde_tpu_torch.train.trainer",
           "mde_tpu_torch.data.loader", "mde_tpu_torch.data.dataset", "mde_tpu_torch.models.factory",
           "mde_tpu_torch.core.config"]


def _bench_modules():
    out = []
    for package in ("harness", "reference", "traffic", "roofline"):
        for path in sorted((spec.BENCH_DIR / package).glob("*.py")):
            if path.stem != "__init__":
                out.append(f"gpubench.{package}.{path.stem}")
    return out


def test_nothing_loads_jax():
    files = [str(spec.BENCH_DIR / "run.py"), str(spec.BENCH_DIR / "control.py"),
             *map(str, sorted((spec.BENCH_DIR / "metrics").glob("*.py")))]
    modules = _bench_modules() + PROGRAM
    assert len(modules) > 15
    out = subprocess.run([sys.executable, "-c", CHILD, json.dumps([str(spec.ROOT), modules, files])],
                         capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mde_tpu_torch" in loaded and "gpubench" in loaded
    assert not loaded & cli.FORBIDDEN


def test_whole_names():
    allowed = ["mde_tpu_torch", "mde_tpu_torch.tools.serve", "jaxtyping", "flaxen", "torch"]
    assert cli.loaded_forbidden(allowed) == set()
    assert cli.loaded_forbidden(allowed + ["mde_tpu.ops"]) == {"mde_tpu"}
    assert cli.loaded_forbidden(["jax", "jaxlib.xla_client", "flax.linen"]) == {"jax", "jaxlib",
                                                                               "flax"}
