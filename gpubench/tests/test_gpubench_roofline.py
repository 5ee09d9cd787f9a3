"""The FLOP and byte formulas against counts worked out by hand at one shape."""

import pytest
import torch

from gpubench.roofline import kernels, model, peaks


def test_bound_takes_the_larger():
    # 1e9 FLOP at the bf16 peak against 1e6 bytes at the memory rate
    out = kernels.bound(1e9, 1e6, "bf16")
    assert out["bound_s"] == pytest.approx(1e9 / 989e12) and out["bound_by"] == "operations"
    out = kernels.bound(1e3, 3.35e9, "f32")
    assert out["bound_s"] == pytest.approx(1e-3) and out["bound_by"] == "bytes"


def test_k4_by_hand():
    # B=2, N=10, H=3, D=4: q k^T is 2*3 heads of 10x10 dot products of length 4,
    # 2 FLOP a multiply-add: 2*3*10*10*4*2 = 4800; P V the same: 9600 in all
    assert kernels.k4_flop(2, 10, 3, 4) == 9600
    # q, k, v and out: 4 tensors of 2*10*3*4 = 240 elements
    assert kernels.k4_bytes(2, 10, 3, 4, 4) == 4 * 240 * 4
    f32 = kernels.k4_bound(2, 10, 3, 4, float32=True)
    assert f32["bound_s"] == pytest.approx(max(3 * 9600 / 495e12, 3840 / 3.35e12))
    bf16 = kernels.k4_bound(2, 10, 3, 4, float32=False)
    assert bf16["bound_s"] == pytest.approx(max(9600 / 989e12, 1920 / 3.35e12))
    # DA-V2-S's frame: 12 layers of (1, 1345, 6, 64), 3xTF32
    frame = 12 * kernels.k4_bound(1, 1345, 6, 64, float32=True)["bound_s"]
    assert frame == pytest.approx(12 * 3 * 4 * 6 * 1345**2 * 64 / 495e12)


def test_k1_by_hand():
    # B=1, N=2 windows of T=4 keys, 2 heads of 8: 1*2*2*4*4 = 64 pairs
    out = kernels.k1_forward_bound(1, 2, 4, 2, 8, 4, sms=132, sm_clock_hz=1.98e9)
    bytes_s = (4 * 1 * 2 * 4 * 2 * 8 * 4 + 4 * 2 * 4) / peaks.HBM_BYTES_PER_S
    flop_s = 4 * 8 * 64 / peaks.PEAK_FLOPS["f32"]
    exp_s = 64 / (132 * 16 * 1.98e9)
    assert out["bound_s"] == pytest.approx(max(bytes_s, flop_s, exp_s))


def test_model_count_by_hand():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dw = torch.nn.Conv2d(3, 3, 3, 2, 1, groups=3, bias=False)  # depthwise
            self.pw = torch.nn.Conv2d(3, 6, 1, bias=False)
            self.up = torch.nn.ConvTranspose2d(6, 2, 2, 2, bias=False)

        def forward(self, x):
            return self.up(self.pw(self.dw(x)))[:, 0]

    with torch.device("meta"):
        net = Net()
    # batch 2 at 8x8. dw: 3 channels of 4x4 outputs, 9 taps: 2*3*16*9*2 = 1728;
    # pw: 2*16*6*3*2 = 1152; up: each of 16 input pixels of 6 channels to 2x2
    # outputs of 2 channels: 2*16*6*(2*2*2)*2 = 3072
    forward = 1728 + 1152 + 3072
    assert model.count(net, 2, (8, 8), train=False) == forward
    # the backward: the weight gradients of all three, and the input gradients
    # of pw and up (the image needs none), each as many FLOP as its forward
    assert model.count(net, 2, (8, 8), train=True) == forward + forward + 1152 + 3072


def test_vit_attention_from_the_widths():
    from gpubench.harness import spec

    # the flagship's DINOv2 runs at 224x280 whatever the model's input: 16x20
    # patches of 14 and the class token
    flagship = spec.load_json(spec.BENCH_DIR / "configs/flagship.json")
    assert kernels.vit_attention(flagship, (448, 576)) == {"tokens": 16 * 20 + 1, "heads": 6,
                                                           "head_dim": 64, "layers": 12}
    assert kernels.vit_attention(flagship, (64, 96))["tokens"] == 16 * 20 + 1
    # a trunk without an image size of its own runs at the model's input:
    # 448x588 gives 32x42 patches
    trunk = {k: v for k, v in flagship["widths"]["vit"].items() if k != "image_size"}
    assert kernels.vit_attention({"widths": {"vit": trunk}}, (448, 588))["tokens"] == 32 * 42 + 1


def test_rows_run_counts_each_bucket_whole():
    from gpubench.traffic.closed_loop import _rows_run

    # 8 replies of full steps (one step of 8), 6 replies of steps of 3 (two steps,
    # each padded to 4) and one reply of a step of 1: 8 + 2*4 + 1 rows
    assert _rows_run({8: 8, 3: 6, 1: 1}, (1, 2, 4, 8)) == 17


def test_leaf_and_part_distances_see_a_direction():
    from gpubench.harness import compare

    want = {"a.x": torch.tensor([3.0, 4.0]), "a.y": torch.tensor([0.0, 1.0]),
            "b.z": torch.tensor([1.0, 0.0])}
    got = {"a.x": -want["a.x"], "a.y": want["a.y"], "b.z": want["b.z"]}
    leaves = set(want)
    # the norms agree; the negated leaf is 2 of its norm away, the rest 0
    assert compare.leaf_distances(got, want, leaves) == {"a.x": 2.0, "a.y": 0.0, "b.z": 0.0}
    # part a: |(-6, -8, 0, 0)| over |(3, 4, 0, 1)| = 10 / sqrt(26); part b: 0
    parts = compare.part_distances(got, want, leaves)
    assert parts["a"] == pytest.approx(10 / 26**0.5) and parts["b"] == 0.0
