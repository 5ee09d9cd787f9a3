"""K4's forward (``flash_attention_kernel``) against its roofline (%), in the
traced sub-window: the least time that the rows its calls ran there need of
it (the ViT's attention shape a row and its layers, ``roofline/kernels.py``;
float32 as 3xTF32) over the kernel's device time. The rows are those of the
device steps whose replies came in the sub-window, each step's bucket
whole: the rows the batcher pads a bucket with are K4's work too
(``serve.bucket_fill_pct`` gives the share that frames fill)."""

from gpubench.roofline.kernels import KERNEL_NAMES, k4_bound, vit_attention


def read(run):
    trace, rows = run.record.get("trace"), run.record.get("trace_rows")
    if trace is None or not rows:
        return None
    seconds = trace.device_seconds(KERNEL_NAMES["flash_attention"])
    if seconds <= 0:
        return None
    a = vit_attention(run.config_file, run.cfg.framework.input_size)
    need = k4_bound(1, a["tokens"], a["heads"], a["head_dim"], float32=True)["bound_s"]
    return 100.0 * rows * a["layers"] * need / seconds
