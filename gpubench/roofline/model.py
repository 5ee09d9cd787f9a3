"""A model's FLOP, counted once over the benchmark's own reference on the meta
device at the cell's shapes, so the count is the same whatever implements
the model.

``torch.utils.flop_counter`` counts matrix products and convolutions (two
operations a multiply-add). Its formula for a convolution's backward
ignores groups (it counts a depthwise convolution's input and weight
gradients as if every channel met every other); here each gradient that the
backward computes counts what the forward convolution counts, which is
exact for grouped, strided and transposed convolutions alike.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from ..reference import pipeline


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    forward = conv_flop_count(list(x_shape), list(w_shape), list(grad_out_shape), transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count(model: torch.nn.Module, batch: int, input_size, train: bool) -> int:
    """FLOP of ``model`` (on the meta device) at ``batch`` x 3 x ``input_size``:
    the eval forward, or with ``train`` the train-mode forward, the loss and
    the backward (parameters that do not require grad get none)."""
    x = torch.empty((batch, 3, *input_size), device="meta")
    mapping = {torch.ops.aten.convolution_backward: _conv_backward_flop}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        if train:
            model.train()
            pred = model(x)
            pipeline.si_loss(pred, torch.empty_like(pred)).backward()
        else:
            model.eval()
            with torch.no_grad():
                model(x)
    return counter.get_total_flops()


def mfu_pct(run, items: int, per: int, train: bool) -> float:
    """The share (%) of the configuration's peak that ``items`` batches of
    ``per`` rows of the model's FLOP (``count`` over the reference) take
    over the run's window."""
    from ..harness import program
    from .peaks import PEAK_FLOPS, PEAK_OF_PRECISION

    mode = "train" if train else "serve"
    ref = program.reference_model(run.config_file, "meta", run.reference_kwargs)
    flop = count(ref, per, run.cfg.framework.input_size, train)
    rate = PEAK_FLOPS[PEAK_OF_PRECISION[run.config_file["precision"][mode]]]
    return 100.0 * flop * items / run.record["window_s"] / rate
