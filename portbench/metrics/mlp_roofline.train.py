"""The MLP kernels' share of their roofline, in %: the least time of the
step's MLP work from its shapes (``portbench/counts.py``) over the
device time of the kernels ``portbench/tracing.py`` names the MLP's."""

from portbench import layer


def read(run):
    return layer.mlp_roofline(run, "train")
