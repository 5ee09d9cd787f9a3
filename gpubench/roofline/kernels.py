"""Operations, bytes and the least time of the program's hand-written kernels,
from their shapes (copied from the on-card check, ``chip_smoke.py``).

A bound is the larger of the operations at the peak of the rate they run in
and the bytes at the memory rate, each input read once and each output
written once. ``KERNEL_NAMES`` gives the device kernels each wrapper
launches, as the profiler names them.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS, SFU_EX2_PER_CLOCK

KERNEL_NAMES = {
    "window_attention": ("window_attention_kernel",),
    "window_attention_backward": ("window_attention_backward_kernel",),
    "preprocess_u8": ("preprocess_u8_kernel",),
    "preprocess_u8_train": ("preprocess_train_kernel",),
    "si_loss_sums": ("si_sums_kernel",),
    "si_loss_sums_backward": ("si_backward_kernel",),
    "flash_attention": ("flash_attention_kernel",),
    "flash_attention_backward": ("flash_attention_delta_kernel", "flash_attention_dkdv_kernel",
                                 "flash_attention_dq_kernel"),
}


def bound(flop: float, nbytes: float, rate: str) -> dict:
    """The least time (s) the card could take: ``flop`` operations at the
    peak of ``rate`` against ``nbytes`` at the memory rate, the larger."""
    ops_s = flop / PEAK_FLOPS[rate]
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s), "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def k4_flop(b: int, n: int, h: int, d: int) -> int:
    """K4's forward: two products, 4 B H N^2 D (its backward does 2.5x that)."""
    return 4 * b * h * n * n * d


def k4_bytes(b: int, n: int, h: int, d: int, elem_bytes: int) -> int:
    """K4's forward reads q, k and v and writes its output once."""
    return 4 * b * n * h * d * elem_bytes


def k4_bound(b: int, n: int, h: int, d: int, float32: bool) -> dict:
    """K4's forward: bf16 on the tensor cores; float32 as the kernel runs it,
    3xTF32 (three TF32 products a product, the least time for float32
    accuracy)."""
    if float32:
        return bound(3 * k4_flop(b, n, h, d), k4_bytes(b, n, h, d, 4), "tf32")
    return bound(k4_flop(b, n, h, d), k4_bytes(b, n, h, d, 2), "bf16")


def vit_attention(config_file: dict, input_size) -> dict:
    """A ViT trunk's attention a frame, from the configuration's ``widths``:
    ``vit`` gives its layers, heads, head size and patch, and its image size
    where the trunk runs at another size than the model's ``input_size``;
    the tokens are its patches and the class token."""
    vit = config_file["widths"]["vit"]
    h, w = (int(s) for s in vit.get("image_size", input_size))
    return {"tokens": (h // vit["patch"]) * (w // vit["patch"]) + 1, "heads": vit["heads"],
            "head_dim": vit["head_dim"], "layers": vit["layers"]}


def k1_forward_bound(b: int, n: int, t: int, heads: int, hd: int, elem_bytes: int,
                     sms: int, sm_clock_hz: float) -> dict:
    """K1's forward in either element type: it computes in float32 on the
    CUDA cores, so the larger of q/k/v/out and the key mask at the memory
    rate, 4 hd FLOP a (query, key, head) pair at the float32 rate, and one
    exponential a pair at SFU_EX2_PER_CLOCK an SM a clock."""
    pairs = b * n * heads * t * t
    bytes_s = (4 * b * n * t * heads * hd * elem_bytes + 4 * n * t) / HBM_BYTES_PER_S
    flop_s = 4 * hd * pairs / PEAK_FLOPS["f32"]
    exp_s = pairs / (sms * SFU_EX2_PER_CLOCK * sm_clock_hz)
    return {"bound_s": max(bytes_s, flop_s, exp_s),
            "bound_by": "bytes" if bytes_s >= max(flop_s, exp_s) else "operations"}
