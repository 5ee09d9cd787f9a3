"""Data-parallel training across processes (port of mde_tpu/parallel, its
data axis): the runtime (``distributed``), the world and row layout and the
model wrapper (``mesh``), the cross-process BatchNorm (``sync_batchnorm``)
and the launcher (``launch``)."""
