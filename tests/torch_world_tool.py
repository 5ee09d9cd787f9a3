"""One of the port's tools with the flagship's DINOv2 branch at the CPU
tests' small geometry (28x42), in this process and in every rank it starts:

    python -m tests.torch_world_tool serve|evaluation|generate_predictions ARGS

The tools build their model from the config (DINOv2 at its default
224x280); this runs the tool's ``main`` with ``common.build_model`` building
the flagship at 28x42 (its weights come from the checkpoint, as
``tests/test_torch_tools.py`` patches it in one process), and with
``launch.spawn`` starting this module, so that the ranks build it too.
Imports nothing of JAX.
"""

import importlib
import sys

from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
from mde_tpu_torch.nn.blocks import init_weights_
from mde_tpu_torch.parallel import launch
from mde_tpu_torch.tools import common

DINO = (28, 42)
TOOLS = ("serve", "evaluation", "generate_predictions")


def build_model(model_cfg, device, generator):
    return init_weights_(MidasNetSemantics(dinov2_image_size=DINO), generator).to(device)


def run(tool: str, argv: list):
    if tool not in TOOLS:
        raise SystemExit(f"tool {tool!r}: one of {TOOLS}")
    common.build_model = build_model
    spawn = launch.spawn
    launch.spawn = lambda module, args, *rest, **kw: spawn(
        "tests.torch_world_tool", [tool, *args], *rest, **kw)
    return importlib.import_module(f"mde_tpu_torch.tools.{tool}").main(argv)


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2:])
