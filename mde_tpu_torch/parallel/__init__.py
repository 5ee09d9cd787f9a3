"""Training across processes (port of mde_tpu/parallel): the runtime and its
data and model groups (``distributed``), the (data, model) world, the row
layout, the tensor-parallel layout and the model wrapper (``mesh``), the
Megatron layers and collectives (``tensor``), the cross-process BatchNorm
(``sync_batchnorm``) and the launcher (``launch``)."""
