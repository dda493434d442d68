"""Device ms a step outside the MLP kernels: sampling, the IPE, compositing,
the dp loss, the weight pack and Adam."""

from portbench import layer


def read(run):
    return layer.other_device_ms(run, "train")
