"""The frozen references against the program's plain path at a small
geometry: the predict step (flagship at 64x96 with DINOv2 at 28x42), the
train pipeline's jitter from one generator, the loss and
the optimizer's update."""

import numpy as np
import pytest
import torch

from gpubench.harness import program, spec
from gpubench.reference import pipeline
from gpubench.traffic.closed_loop import _frames
from gpubench.traffic.train_epochs import step_generator

CASES = {"flagship": ({"dinov2_image_size": (28, 42)}, (64, 96))}


def _models(name, mode="serve"):
    kwargs, size = CASES[name]
    config = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
    sets = [f"framework.input_size=[{size[0]},{size[1]}]", "framework.native_size=[60,80]"]
    cfg = program.config(config, sets)
    state = program.weights(config, mode, 3, "cpu", kwargs)
    prog = program.model(cfg, state, "cpu", kwargs)
    ref = program.reference_model(config, "meta", kwargs).to_empty(device="cpu")
    ref.load_state_dict(state)
    return cfg, prog, ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_predict_step(name):
    from mde_tpu_torch.train.trainer import make_predict_step

    cfg, prog, ref = _models(name)
    frames = torch.from_numpy(_frames(3, 60, 80, 11, "cpu"))
    got = make_predict_step(prog, cfg, plain=True)(frames)
    want = pipeline.predict(ref, frames, cfg.framework.input_size, cfg.framework.native_size)
    assert got.shape == want.shape == (3, 60, 80)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def test_train_pipeline_from_one_generator():
    from mde_tpu_torch.data.transforms import preprocess_train

    rgb = torch.from_numpy(_frames(4, 60, 80, 12, "cpu"))
    depth = torch.rand((4, 60, 80), generator=torch.Generator().manual_seed(1)) * 9 + 0.5
    got_rgb, got_depth = preprocess_train(rgb, depth, (64, 96), generator=step_generator(7, 0, 2),
                                          plain=True)
    want_rgb, want_depth = pipeline.preprocess_train(rgb, depth, (64, 96), step_generator(7, 0, 2))
    torch.testing.assert_close(got_rgb, want_rgb, rtol=0, atol=2e-6)
    torch.testing.assert_close(got_depth, want_depth, rtol=0, atol=1e-6)


def test_step_generator_is_the_programs():
    from mde_tpu_torch.train.trainer import step_generator as programs

    for args in ((0, 0, 0), (2**40 + 3, 5, 63)):
        assert torch.equal(torch.rand(4, generator=step_generator(*args)),
                           torch.rand(4, generator=programs(*args)))


def test_loss_and_update():
    from mde_tpu_torch.losses.losses import combined_loss

    cfg, prog, _ = _models("flagship", "train")
    g = torch.Generator().manual_seed(2)
    pred = torch.rand((2, 16, 20), generator=g) * 5 + 0.1
    target = torch.rand((2, 16, 20), generator=g) * 5 + 0.1
    total, _ = combined_loss(pred, target, cfg, rgb=torch.rand((2, 3, 16, 20), generator=g))
    torch.testing.assert_close(total, pipeline.si_loss(pred, target), rtol=1e-6, atol=0)

    params = {"w": torch.nn.Parameter(torch.rand((3, 4), generator=g))}
    mine = {"w": torch.nn.Parameter(params["w"].detach().clone())}
    torch_opt = torch.optim.AdamW(params.values(), lr=1e-2, weight_decay=1e-2)
    plain_opt = pipeline.AdamW(mine, lr=1e-2, weight_decay=1e-2)
    for _ in range(3):
        grad = torch.rand((3, 4), generator=g) - 0.5
        params["w"].grad, mine["w"].grad = grad.clone(), grad.clone()
        torch_opt.step()
        plain_opt.step()
    np.testing.assert_allclose(mine["w"].detach().numpy(), params["w"].detach().numpy(),
                               rtol=1e-6, atol=1e-7)
